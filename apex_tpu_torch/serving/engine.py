"""The continuous-batching serving engine (``apex_tpu/serving/engine.py``),
slot or paged KV layout, native or int8 pool, float or quantized
weights.

Lifecycle::

    engine = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                           cache_layout="paged")
    rid = engine.submit([1, 2, 3], max_new_tokens=32, eos_token_id=50256)
    while not engine.idle:
        for resp in engine.step():       # 0+ completed Responses
            ...
    # or simply: responses = engine.run(requests)

Each :meth:`ServingEngine.step`:

1. **admit** — while a decode lane is free, the queue is non-empty and
   (paged) the free blocks cover the next request plus
   ``reserve_blocks``, pop it, pad its prompt to the smallest bucket,
   run ONE :func:`~apex_tpu_torch.models.generate.prefill` (kernels K1
   and K2, and row 10 for quantized weights) into a bucket-sized cache,
   scatter that into the request's KV storage (an int8 pool quantizes
   it on the way), and sample the first token from the prefill logits;
2. **decode** — one :func:`~apex_tpu_torch.models.generate.decode_step`
   over ALL ``max_slots`` lanes (the batch stays rectangular; inactive
   lanes ride along with their position frozen and, paged, sentinel
   table rows, so their writes drop), then per-lane sampling; one host
   sync per step reads the new tokens;
3. **complete** — lanes whose token hit ``eos_token_id`` or whose budget
   ran out become :class:`Response` and are released.

The paged layout admits by block budget, shares identical full prompt
blocks (refcounted, digests from
:func:`~apex_tpu_torch.serving.paged_cache.prefix_block_hashes`), and,
when decode needs a tail block and the pool is dry, preempts the
youngest live request: its blocks free at once and it requeues at the
front with its progress; resume replays prompt + generated tokens
through prefill.

Multi-tenant LoRA: with ``adapter_pool=``
(:class:`~apex_tpu_torch.serving.adapter_pool.AdapterPool`),
``submit(adapter_id=k)`` serves a registered adapter.  Admission pins
the adapter's slab slot first (FIFO: a head request whose pool is pinned
full waits, and nothing jumps it), prefills the prompt through
:func:`~apex_tpu_torch.models.generate.decode_verify` with the delta,
into fresh blocks that are never published (adapter K/V is the
tenant's own), and every decode step passes the per-lane slot ids, so
the whole batch runs the grouped matmul (kernel row 9) at the four
target matmuls.  Completion and preemption unpin.

Differences from the JAX engine: pools are updated in place; sampling
draws its key words from a ``torch.Generator`` (``generator=``), so
sampled lanes are reproducible per seed but not the JAX tokens (greedy
lanes are the identity contract); there is nothing to compile, so the
buckets bound the shapes a per-bucket CUDA-graph capture would need.
Not ported yet (raise ``NotImplementedError``): ``spec``,
``chunk_tokens``, ``host_tier_bytes``, ``compile_cache_dir``,
``token_masks``, ``submit_prefilled`` and ``drain``.

Telemetry (no-op unless :func:`~apex_tpu_torch.observability.configure`
ran) uses the JAX engine's names: ``serving.{requests,prefill_calls,
decode_steps,tokens_generated,preemptions}`` counters, occupancy, queue
and block gauges, per-class ``serving.{queue_wait_ms,ttft_ms,tpot_ms,
e2e_ms,preempt_overhead_ms}`` sketches, ``serving.goodput.{met,
missed}`` and ``serving.adapter.requests{adapter=}``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.generate import (
    _check_decode_cfg, _compute_dtype_params, decode_step, decode_verify,
    init_kv_cache, prefill)
from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.observability import span
from apex_tpu_torch.observability.device import (
    compile_label, sample_device_memory)
from apex_tpu_torch.ops.fused_sampling import fused_sample
from apex_tpu_torch.serving.batching import (
    SlotPool, default_buckets, pad_prompt, pick_bucket)
from apex_tpu_torch.serving.paged_cache import (
    BlockManager, blocks_for, init_paged_pool, paged_insert_prefill,
    paged_insert_prefill_q, prefix_block_hashes, resolve_cache_wire)
from apex_tpu_torch.serving.slo import judge as _judge_slo
from apex_tpu_torch.serving.slo import resolve_slo_targets
from apex_tpu_torch.serving.slo import tpot_ms as _tpot_ms
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["Request", "Response", "ServingEngine"]

DIGEST_INVENTORY_N = 64


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int token array."""

    prompt: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    request_id: Optional[int] = None
    slo_class: str = "default"
    # the LoRA adapter this request decodes through, 0 = base model
    adapter_id: int = 0
    # lifecycle stamps (perf_counter seconds; 0.0 = not yet)
    submitted_t: float = 0.0
    admitted_t: float = 0.0
    first_token_t: float = 0.0
    queue_wait_s: float = 0.0
    preempted_t: float = 0.0
    preempt_overhead_s: float = 0.0
    # tokens generated before a preemption: resume replays
    # prompt + resume_tokens through prefill
    resume_tokens: List[int] = dataclasses.field(
        default_factory=list, repr=False)
    preemptions: int = 0
    # decode polls before the latest preemption
    resume_polls: int = 0
    # memoized (token count, full tokens, prefix digests)
    _hash_cache: Optional[tuple] = dataclasses.field(
        default=None, repr=False)
    # the 1-based AdapterPool slot acquire() pinned (0 = no ref held);
    # release keys off it, so a double release cannot happen
    _lane: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} must be >= 1")
        if self.temperature < 0:
            raise ValueError(
                f"temperature={self.temperature}: negative temperatures "
                "would invert the distribution; pass 0 for greedy or a "
                "positive value")
        if self.adapter_id < 0:
            raise ValueError(
                f"adapter_id={self.adapter_id} must be >= 0 (0 = base)")


@dataclasses.dataclass
class Response:
    """A completed request: generated tokens (prompt excluded) and its
    SLO accounting."""

    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray
    finish_reason: str            # 'eos' | 'length'
    prefill_ms: float
    decode_steps: int
    slo_class: str = "default"
    queue_wait_ms: float = 0.0
    ttft_ms: float = 0.0
    tpot_ms: float = 0.0
    e2e_ms: float = 0.0
    preemptions: int = 0
    preempt_overhead_ms: float = 0.0
    slo_met: bool = True


@dataclasses.dataclass
class _Slot:
    """Host bookkeeping for one live decode lane."""

    request: Request
    tokens: List[int]
    prefill_ms: float
    blocks: List[int] = dataclasses.field(default_factory=list)
    cache_len: int = 0            # tokens materialized in the KV cache
    shared_blocks: int = 0        # prefix blocks mapped, not allocated
    decode_polls: int = 0


_UNPORTED = ("spec", "chunk_tokens", "host_tier_bytes", "host_tier_wire",
             "compile_cache_dir")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class ServingEngine:
    """Continuous-batching engine over a fixed pool of decode lanes.

    ``max_len`` bounds prompt + generation per request.
    ``cache_layout``: ``"contiguous"`` reserves a ``max_len`` stripe per
    lane; ``"paged"`` commits memory per allocated ``block_size``-token
    block of a ``num_blocks`` pool (default ``max_slots ×
    ceil(max_len / block_size)``; with ``cache_wire="int8"`` the blocks
    that the native pool's bytes would buy).  ``reserve_blocks`` is the
    paged admission margin.  ``top_k`` / ``top_p`` / ``vocab_limit`` are
    engine-wide sampling knobs; temperature is per request.
    ``generator`` (a CPU ``torch.Generator``, default seeded 0) keys the
    sampled lanes.  ``adapter_pool`` serves LoRA adapters (module doc).
    ``device`` defaults to ``cuda``; ``backend="reference"`` pins every
    op to its plain version (tests and ``chip_smoke.py``)."""

    def __init__(self, params: dict, cfg: TransformerConfig, *,
                 max_slots: int = 8, max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 cache_layout: str = "contiguous", cache_wire=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 reserve_blocks: int = 1, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 vocab_limit: Optional[int] = None,
                 slo_targets: Optional[dict] = None,
                 spec=None, chunk_tokens: Optional[int] = None,
                 host_tier_bytes: Optional[int] = None,
                 host_tier_wire: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None,
                 adapter_pool=None, token_masks: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device=None, backend: Optional[str] = None):
        given = dict(spec=spec, chunk_tokens=chunk_tokens,
                     host_tier_bytes=host_tier_bytes,
                     host_tier_wire=host_tier_wire,
                     compile_cache_dir=compile_cache_dir)
        for name in _UNPORTED:
            if given[name] not in (None, "off"):
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet; it "
                    "comes with a later slice of the port (ROADMAP.md)")
        if token_masks:
            raise NotImplementedError(
                "ServingEngine(token_masks=True) (constrained decoding) "
                "comes with a later slice of the port")
        _check_decode_cfg(cfg)
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"cache_layout={cache_layout!r}: expected 'contiguous' "
                "or 'paged'")
        self.cache_wire = resolve_cache_wire(cache_wire)
        if self.cache_wire != "native" and cache_layout != "paged":
            raise ValueError(
                f"cache_wire={cache_wire!r} needs cache_layout='paged' — "
                "int8 at rest is a block-pool form")
        self.device = resolve_device(device)
        self.backend = check_backend(backend)
        self.cfg = cfg
        self.params = _compute_dtype_params(params, cfg)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.max_position_embeddings)
        if (cfg.position_embedding_type == "learned"
                and self.max_len > cfg.max_position_embeddings):
            raise ValueError(
                f"max_len={self.max_len} exceeds the learned position "
                f"table ({cfg.max_position_embeddings})")
        self.buckets = tuple(sorted(prompt_buckets
                                    or default_buckets(self.max_len)))
        if self.buckets[-1] > self.max_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets[-1]} exceeds "
                f"max_len {self.max_len}")
        self._submit_buckets = self.buckets
        if cache_layout == "paged" and self.buckets[-1] < self.max_len:
            # a resume replays prompt + generated tokens, up to max_len
            self.buckets = tuple(sorted(
                set(self.buckets)
                | {b for b in default_buckets(self.max_len)
                   if b > self.buckets[-1]}))
        self.cache_layout = cache_layout
        self._cache_dtype = cache_dtype or cfg.compute_dtype
        itemsize = torch.empty((), dtype=self._cache_dtype).element_size()
        dev = self.device
        if cache_layout == "paged":
            self.block_size = int(block_size)
            mb = blocks_for(self.max_len, self.block_size)
            if num_blocks:
                self.num_blocks = int(num_blocks)
            elif self.cache_wire == "int8":
                cell = self.block_size * cfg.kv_groups
                native_b = cell * cfg.kv_channels * itemsize
                int8_b = cell * cfg.kv_channels + 4 * cell
                self.num_blocks = max(
                    mb, self.max_slots * mb * native_b // int8_b)
            else:
                self.num_blocks = self.max_slots * mb
            if reserve_blocks < 0:
                raise ValueError(
                    f"reserve_blocks={reserve_blocks} must be >= 0")
            self.reserve_blocks = int(reserve_blocks)
            pool = init_paged_pool(cfg, self.num_blocks, self.block_size,
                                   cache_dtype=cache_dtype,
                                   cache_wire=self.cache_wire, device=dev)
            self.cache = dict(pool, pos=torch.zeros(
                self.max_slots, dtype=torch.int32, device=dev))
            self._mgr = BlockManager(self.num_blocks, self.block_size)
            # num_blocks is the unmapped sentinel: a released lane never
            # touches a reassigned block
            self._tables = np.full((self.max_slots, mb), self.num_blocks,
                                   np.int32)
        else:
            self.cache = init_kv_cache(cfg, self.max_slots, self.max_len,
                                       cache_dtype=cache_dtype, device=dev)
            self._mgr = None
            self._tables = None
        self._cache_bytes = int(sum(
            v.numel() * v.element_size() for k, v in self.cache.items()
            if k != "pos"))
        self._wire_dtype_name = ("int8" if self.cache_wire == "int8"
                                 else _dtype_name(self._cache_dtype))
        self._capacity_tokens = (
            self.num_blocks * self.block_size if self._mgr is not None
            else self.max_slots * self.max_len)
        self._blocks_hw = 0
        self._pool = SlotPool(self.max_slots)
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._queue: deque = deque()
        self._gen = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self._pending = np.zeros((self.max_slots,), np.int32)
        self._temps = np.zeros((self.max_slots,), np.float32)
        # the adapter pool and the per-lane slab index (0 = base), a host
        # mirror uploaded each step like _pending and _temps
        self._adapters = adapter_pool
        self._lane_slab = np.zeros((self.max_slots,), np.int32)
        self._next_id = 0
        self._decode_count = 0
        self._prefill_count = 0
        self._preempt_count = 0
        self._sampling = dict(top_k=top_k, top_p=top_p,
                              vocab_limit=vocab_limit)
        self._slo_targets = resolve_slo_targets(slo_targets)

    # -- public API --------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               slo_class: str = "default", adapter_id: int = 0,
               token_mask_fn=None) -> int:
        """Queue one request; returns its request id.  ``adapter_id``
        selects an adapter registered on the engine's pool (0 = base
        model)."""
        if token_mask_fn is not None:
            raise NotImplementedError(
                "token_mask_fn (constrained decoding) comes with a later "
                "slice of the port")
        if adapter_id:
            if self._adapters is None:
                raise ValueError(
                    f"adapter_id={adapter_id} but the engine has no "
                    "adapter_pool — pass adapter_pool= at construction")
            if not self._adapters.registered(adapter_id):
                raise ValueError(
                    f"adapter_id={adapter_id} is not registered on the "
                    "engine's adapter pool")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=self._next_id, slo_class=str(slo_class),
                      adapter_id=int(adapter_id))
        if req.prompt.size + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({req.prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the engine max_len "
                f"({self.max_len}); raise max_len or shorten the request")
        pick_bucket(req.prompt.size, self._submit_buckets)
        self._check_pool_budget(req)
        if self._mgr is not None:
            self._admission_state(req)       # digests once, at submit
        self._next_id += 1
        req.submitted_t = time.perf_counter()
        self._queue.append(req)
        _telemetry.counter("serving.requests").inc()
        if req.adapter_id:
            _telemetry.counter("serving.adapter.requests",
                               {"adapter": str(req.adapter_id)}).inc()
        _telemetry.event("serving.request.begin", id=req.request_id,
                         prompt_tokens=int(req.prompt.size),
                         max_new_tokens=req.max_new_tokens,
                         slo_class=req.slo_class)
        self._set_gauges()
        return req.request_id

    def submit_prefilled(self, *args, **kwargs):
        raise NotImplementedError(
            "submit_prefilled (KV handoff, the cluster tier) comes with a "
            "later slice of the port")

    def drain(self):
        raise NotImplementedError(
            "drain (lossless scale-down, the cluster tier) comes with a "
            "later slice of the port")

    def _check_pool_budget(self, req: Request) -> None:
        """Reject a request that could never complete even alone."""
        if self._mgr is None:
            return
        horizon = min(req.prompt.size + req.max_new_tokens,
                      blocks_for(self.max_len, self.block_size)
                      * self.block_size)
        worst = blocks_for(horizon, self.block_size) + self.reserve_blocks
        if worst > self.num_blocks:
            raise ValueError(
                f"request needs up to {worst} blocks (prompt "
                f"{req.prompt.size} + max_new_tokens {req.max_new_tokens} "
                f"at block_size {self.block_size}, + {self.reserve_blocks} "
                f"reserve) but the pool holds {self.num_blocks}; it could "
                "never run to completion even alone")

    @property
    def idle(self) -> bool:
        """True when no request is queued or in flight."""
        return not self._queue and self._pool.n_active == 0

    def step(self) -> List[Response]:
        """Admit what fits, decode one token for every live lane; returns
        the requests completed by this step."""
        completed = self._admit()
        if any(st is not None for st in self._slots):
            completed.extend(self._decode_once())
        self._set_gauges()
        return completed

    def run(self, requests: Sequence[dict] = (),
            max_steps: Optional[int] = None) -> List[Response]:
        """Submit ``requests`` (dicts of :meth:`submit` kwargs), step until
        drained, return responses sorted by request id."""
        for kw in requests:
            self.submit(**kw)
        out: List[Response] = []
        steps = 0
        while not self.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return sorted(out, key=lambda r: r.request_id)

    def stats(self) -> dict:
        """Engine state snapshot (the JAX engine's keys, minus the
        features not ported yet, plus ``decode_steps`` and
        ``prefill_calls``)."""
        by_class: dict = {}
        for req in self._queue:
            by_class[req.slo_class] = by_class.get(req.slo_class, 0) + 1
        out = {
            "queued": len(self._queue),
            "queued_by_class": by_class,
            "active": self._pool.n_active,
            "free_slots": self._pool.n_free,
            "max_slots": self.max_slots,
            "max_len": self.max_len,
            "buckets": self.buckets,
            "cache_layout": self.cache_layout,
            "cache_wire": self.cache_wire,
            "cache_bytes": self._cache_bytes,
            "sampling": dict(self._sampling),
            "spec_k": None,
            "chunk_tokens": None,
            "prefilling": 0,
            "decode_steps": self._decode_count,
            "prefill_calls": self._prefill_count,
        }
        if self._mgr is not None:
            free_blocks = max(0, self._mgr.n_free - self.reserve_blocks)
            out.update({
                "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "blocks_free": self._mgr.n_free,
                "blocks_in_use": self._mgr.n_in_use,
                "blocks_high_water": self._blocks_hw,
                "prefix_shared_blocks": self._mgr.n_shared,
                "preemptions": self._preempt_count,
                "free_block_headroom": free_blocks,
                "headroom_tokens": free_blocks * self.block_size,
                "digest_inventory": {
                    "block_size": self.block_size,
                    "chunk_tokens": None,
                    "hbm": [h.hex()[:16] for h in
                            self._mgr.newest_digests(DIGEST_INVENTORY_N)],
                    "host": [],
                },
            })
        else:
            out["free_block_headroom"] = self._pool.n_free
            out["headroom_tokens"] = self._pool.n_free * self.max_len
        if self._adapters is not None:
            out["adapter_pool"] = self._adapters.stats()
        return out

    # -- internals ---------------------------------------------------------

    def _set_gauges(self) -> None:
        _telemetry.gauge("serving.slot_occupancy").set(
            self._pool.n_active / self.max_slots)
        _telemetry.gauge("serving.queue_depth").set(len(self._queue))
        tags = {"dtype": self._wire_dtype_name}
        _telemetry.gauge("serving.cache_bytes", tags).set(self._cache_bytes)
        _telemetry.gauge("serving.cache_capacity_tokens", tags).set(
            self._capacity_tokens)
        if self._mgr is not None:
            self._blocks_hw = max(self._blocks_hw, self._mgr.n_in_use)
            _telemetry.gauge("serving.blocks_in_use").set(
                self._mgr.n_in_use)
            _telemetry.gauge("serving.blocks_free").set(self._mgr.n_free)
            _telemetry.gauge("serving.prefix_shared_blocks").set(
                self._mgr.n_shared)
            _telemetry.gauge("serving.cache_blocks_hw", tags).set(
                self._blocks_hw)

    # -- admission ---------------------------------------------------------

    def _admission_state(self, req: Request):
        """(full token array, prefix digests) of the request's current
        resume state, memoized on the Request."""
        n = req.prompt.size + len(req.resume_tokens)
        if req._hash_cache is None or req._hash_cache[0] != n:
            tokens = self._full_tokens(req)
            full = n // self.block_size
            req._hash_cache = (n, tokens, prefix_block_hashes(
                tokens[: full * self.block_size], self.block_size))
        return req._hash_cache[1], req._hash_cache[2]

    def _blocks_needed(self, req: Request) -> int:
        """NEW blocks the request must allocate at admission (published
        prefix hits map, they do not allocate)."""
        n = req.prompt.size + len(req.resume_tokens)
        _tokens, hashes = self._admission_state(req)
        need = blocks_for(n, self.block_size)
        for h in hashes:
            if self._mgr.lookup_prefix(h) is not None:
                need -= 1
        return need

    @staticmethod
    def _full_tokens(req: Request) -> np.ndarray:
        """Prompt plus any pre-preemption progress."""
        if not req.resume_tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.resume_tokens, np.int32)])

    def _admit(self) -> List[Response]:
        """Prefill queued requests into free lanes: while a lane is free
        and (paged) the free blocks cover the head request plus
        ``reserve_blocks``.  Returns requests completed at admission."""
        completed = []
        while self._queue and self._pool.n_free:
            req = self._queue[0]
            if (self._mgr is not None
                    and self._mgr.n_free < (self._blocks_needed(req)
                                            + self.reserve_blocks)):
                break      # wait for completions or a preemption
            if req.adapter_id and not req._lane:
                # pin the adapter's slab slot for the whole residency
                # before claiming a lane; None = every slot is pinned by
                # live requests: wait, FIFO (a later request must not
                # jump a blocked adapter head)
                lane = self._adapters.acquire(req.adapter_id)
                if lane is None:
                    break
                req._lane = lane
            self._queue.popleft()
            slot = self._pool.claim()
            try:
                completed.extend(self._admit_one(req, slot))
            except Exception:
                # unwind the pre-handoff state only (the blocks unwind
                # in _admit_one)
                if (self._slots[slot] is None
                        and self._pool.is_active(slot)):
                    self._release_adapter(req)
                    self._pool.release(slot)
                    self._queue.appendleft(req)
                    self._set_gauges()
                raise
        return completed

    def _release_adapter(self, req: Request) -> None:
        """Drop the request's adapter-pool pin, if it holds one: every
        teardown edge (complete, preempt, admission unwind) comes here."""
        if self._adapters is not None and req._lane:
            self._adapters.release(req.adapter_id)
            req._lane = 0

    def _bind_slot_lane(self, req: Request, slot: int) -> None:
        """Stamp the lane's slab index at slot handoff; every teardown
        edge resets it."""
        self._lane_slab[slot] = req._lane

    def _claim_blocks(self, tokens: np.ndarray, hashes: List[bytes]):
        """Map/allocate the block list for ``tokens``: published full
        blocks are shared (not rewritten), the rest allocate, full ones
        publish.  Returns (blocks, write_ids, shared_count); raises on
        exhaustion with everything unwound."""
        blocks: List[int] = []
        write_ids: List[int] = []
        shared = 0
        try:
            for h in hashes:
                blk = self._mgr.share_prefix(h)
                if blk is not None:
                    blocks.append(blk)
                    write_ids.append(self.num_blocks)   # don't rewrite
                    shared += 1
                    continue
                blk = self._mgr.alloc()
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                self._mgr.publish_prefix(h, blk)
                blocks.append(blk)
                write_ids.append(blk)
            if tokens.size % self.block_size:
                blk = self._mgr.alloc()                 # private tail
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                blocks.append(blk)
                write_ids.append(blk)
        except Exception:
            self._mgr.free_all(blocks)
            raise
        return blocks, write_ids, shared

    def _claim_blocks_fresh(self, n_tokens: int) -> List[int]:
        """Allocate ``blocks_for(n_tokens)`` fresh blocks, no prefix
        mapping and no publishing; raises on exhaustion with everything
        unwound."""
        blocks: List[int] = []
        try:
            for _ in range(blocks_for(n_tokens, self.block_size)):
                blk = self._mgr.alloc()
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                blocks.append(blk)
        except Exception:
            self._mgr.free_all(blocks)
            raise
        return blocks

    def _insert_prefill_kv(self, slot: int, bucket: int,
                           write_ids: List[int], ks, vs, n: int) -> None:
        """Write a bucket-sized prefill cache ``[L, 1, bucket, g, dh]``
        into the lane's storage and set its position to ``n``."""
        if self._mgr is not None:
            wid = np.full((blocks_for(bucket, self.block_size),),
                          self.num_blocks, np.int32)
            wid[: len(write_ids)] = write_ids
            c = self.cache
            if self.cache_wire == "int8":
                paged_insert_prefill_q(c["k"], c["v"], c["k_scale"],
                                       c["v_scale"], ks, vs, wid, n,
                                       block_size=self.block_size)
            else:
                paged_insert_prefill(c["k"], c["v"], ks, vs, wid, n,
                                     block_size=self.block_size)
        else:
            self.cache["k"][:, slot, :bucket] = ks[:, 0].to(
                self.cache["k"].dtype)
            self.cache["v"][:, slot, :bucket] = vs[:, 0].to(
                self.cache["v"].dtype)
        self.cache["pos"][slot] = n

    def _sample(self, logits, temps: np.ndarray) -> torch.Tensor:
        """Per-row temperatures: all-greedy rows take the masked argmax
        (no launch); otherwise one fused sampler call whose greedy rows
        (temperature 0) take the same argmax."""
        kw = self._sampling
        if not (temps > 0).any():
            return fused_sample(logits, temperature=0.0,
                                vocab_limit=kw["vocab_limit"],
                                backend=self.backend)
        t = torch.as_tensor(temps, dtype=torch.float32, device=self.device)
        return fused_sample(logits, generator=self._gen, temperature=t,
                            top_k=kw["top_k"], top_p=kw["top_p"],
                            vocab_limit=kw["vocab_limit"],
                            backend=self.backend)

    def _admit_one(self, req: Request, slot: int) -> List[Response]:
        """Prefill one claimed request into its lane (block allocations
        unwind here on failure)."""
        if req.adapter_id:
            return self._admit_one_adapter(req, slot)
        completed: List[Response] = []
        hashes: List[bytes] = []
        if self._mgr is not None:
            tokens, hashes = self._admission_state(req)
        else:
            tokens = self._full_tokens(req)
        n = int(tokens.size)
        bucket = pick_bucket(n, self.buckets)
        blocks: List[int] = []
        write_ids: List[int] = []
        shared = 0
        if self._mgr is not None:
            blocks, write_ids, shared = self._claim_blocks(tokens, hashes)
        t0 = time.perf_counter()
        if req.admitted_t == 0.0:
            req.admitted_t = t0
            req.queue_wait_s = t0 - req.submitted_t
        try:
            with span("serving.prefill"), compile_label("serving.prefill"):
                padded = torch.as_tensor(pad_prompt(tokens, bucket)[None],
                                         dtype=torch.long,
                                         device=self.device)
                lens = torch.tensor([n], dtype=torch.int32,
                                    device=self.device)
                logits, small = prefill(
                    self.params, padded, self.cfg, prompt_lens=lens,
                    max_len=bucket, cache_dtype=self._cache_dtype,
                    device=self.device, backend=self.backend)
                self._insert_prefill_kv(slot, bucket, write_ids,
                                        small["k"], small["v"], n)
                first = self._sample(
                    logits, np.asarray([req.temperature], np.float32))
                tok = int(first[0])                      # host sync
            self._prefill_count += 1
            if self._mgr is not None:
                self._tables[slot, :] = self.num_blocks
                self._tables[slot, : len(blocks)] = blocks
                self._blocks_hw = max(self._blocks_hw, self._mgr.n_in_use)
            now = time.perf_counter()
            ms = (now - t0) * 1e3
            if req.first_token_t == 0.0:
                req.first_token_t = now
                _telemetry.event("serving.request.first_token",
                                 id=req.request_id, slo_class=req.slo_class)
            if req.preempted_t:
                req.preempt_overhead_s += now - req.preempted_t
                req.preempted_t = 0.0
            _telemetry.counter("serving.prefill_calls").inc()
            _telemetry.histogram("serving.prefill_ms").observe(ms)
            _telemetry.counter("serving.tokens_generated").inc()
            if _telemetry.enabled():
                sample_device_memory()
            st = _Slot(request=req, tokens=list(req.resume_tokens) + [tok],
                       prefill_ms=ms, blocks=blocks, cache_len=n,
                       shared_blocks=shared, decode_polls=req.resume_polls)
        except Exception:
            if self._mgr is not None:
                self._mgr.free_all(blocks)
                self._tables[slot, :] = self.num_blocks
            raise
        self._slots[slot] = st
        self._pending[slot] = tok
        self._temps[slot] = req.temperature
        self._bind_slot_lane(req, slot)
        done = self._finish_reason(st, tok)
        if done:
            completed.append(self._complete(slot, done))
        return completed

    def _lora_prefill(self, tokens: np.ndarray, slot: int, lane: int):
        """The prompt, padded to its bucket, through one b=1
        ``decode_verify`` at position 0 with the delta of slab slot
        ``lane``, writing the lane's K/V in place (paged: through the lane's
        table row, stamped before the call); sets the lane's position to
        the prompt's length and returns the logits ``[1, bucket, v]``."""
        dev = self.device
        n = int(tokens.size)
        padded = torch.as_tensor(
            pad_prompt(tokens, pick_bucket(n, self.buckets))[None],
            dtype=torch.long, device=dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        if self._mgr is not None:
            sub = {k: v for k, v in self.cache.items() if k != "pos"}
            sub["block_tables"] = torch.as_tensor(self._tables[slot][None],
                                                  device=dev)
        else:
            sub = {"k": self.cache["k"][:, slot:slot + 1],
                   "v": self.cache["v"][:, slot:slot + 1]}
        sub["pos"] = zero
        lora = {"idx": torch.tensor([lane], dtype=torch.int32, device=dev),
                "slabs": self._adapters.slabs()}
        logits, _ = decode_verify(self.params, padded, sub, self.cfg,
                                  lora=lora, device=dev,
                                  backend=self.backend)
        self.cache["pos"][slot] = n
        return logits

    def adapter_prefill_logits(self, prompt, adapter_id: int) -> torch.Tensor:
        """The logits ``[v]`` from which admitting ``prompt`` under
        ``adapter_id`` samples the first token: the admission's own verify
        call, on a lane, blocks and an adapter pin that an idle engine
        claims for the call and gives back after it."""
        if self._adapters is None or not self.idle or not adapter_id:
            raise RuntimeError("adapter_prefill_logits needs an idle engine "
                               "with an adapter_pool and an adapter_id ≥ 1")
        tokens = np.asarray(prompt, np.int32)
        lane = self._adapters.acquire(int(adapter_id))
        slot = self._pool.claim()
        blocks: List[int] = []
        try:
            if self._mgr is not None:
                blocks = self._claim_blocks_fresh(int(tokens.size))
                self._tables[slot, : len(blocks)] = blocks
            return self._lora_prefill(tokens, slot, lane)[0, tokens.size - 1]
        finally:
            if self._mgr is not None:
                self._tables[slot, :] = self.num_blocks
                self._mgr.free_all(blocks)
            self._pool.release(slot)
            self._adapters.release(int(adapter_id))

    def _admit_one_adapter(self, req: Request, slot: int) -> List[Response]:
        """Admit one LoRA request: the whole prompt through the verify
        forward with the adapter's delta.  Blocks are claimed fresh and
        never published: adapter K/V must not alias the base model's
        prefix digests."""
        completed: List[Response] = []
        tokens = self._full_tokens(req)
        n = int(tokens.size)
        blocks: List[int] = []
        if self._mgr is not None:
            blocks = self._claim_blocks_fresh(n)
        t0 = time.perf_counter()
        if req.admitted_t == 0.0:
            req.admitted_t = t0
            req.queue_wait_s = t0 - req.submitted_t
        try:
            if self._mgr is not None:
                # the verify forward writes through the table row
                self._tables[slot, :] = self.num_blocks
                self._tables[slot, : len(blocks)] = blocks
                self._blocks_hw = max(self._blocks_hw, self._mgr.n_in_use)
            with span("serving.lora_prefill"), \
                    compile_label("serving.prefill"):
                logits = self._lora_prefill(tokens, slot, req._lane)
                first = self._sample(
                    logits[:, n - 1],
                    np.asarray([req.temperature], np.float32))
                tok = int(first[0])                      # host sync
            self._prefill_count += 1
            now = time.perf_counter()
            ms = (now - t0) * 1e3
            if req.first_token_t == 0.0:
                req.first_token_t = now
                _telemetry.event("serving.request.first_token",
                                 id=req.request_id, slo_class=req.slo_class)
            if req.preempted_t:
                req.preempt_overhead_s += now - req.preempted_t
                req.preempted_t = 0.0
            _telemetry.counter("serving.prefill_calls").inc()
            _telemetry.histogram("serving.prefill_ms").observe(ms)
            _telemetry.counter("serving.tokens_generated").inc()
            if _telemetry.enabled():
                sample_device_memory()
            st = _Slot(request=req, tokens=list(req.resume_tokens) + [tok],
                       prefill_ms=ms, blocks=blocks, cache_len=n,
                       shared_blocks=0, decode_polls=req.resume_polls)
        except Exception:
            if self._mgr is not None:
                self._mgr.free_all(blocks)
                self._tables[slot, :] = self.num_blocks
            raise
        self._slots[slot] = st
        self._pending[slot] = tok
        self._temps[slot] = req.temperature
        self._bind_slot_lane(req, slot)
        done = self._finish_reason(st, tok)
        if done:
            completed.append(self._complete(slot, done))
        return completed

    # -- decode ------------------------------------------------------------

    def _youngest_slot(self) -> int:
        """The preemption victim: the most recently submitted live
        request."""
        return max(self._pool.active,
                   key=lambda s: self._slots[s].request.request_id)

    def _preempt(self, slot: int) -> None:
        """Evict one live request: free its blocks (shared prefix blocks
        survive under their other owners), park its progress on the
        Request, requeue it at the front, release the lane."""
        st = self._slots[slot]
        self._slots[slot] = None
        self._pending[slot] = 0
        self._temps[slot] = 0.0
        self._lane_slab[slot] = 0
        self._tables[slot, :] = self.num_blocks
        self._mgr.free_all(st.blocks)
        self._pool.release(slot)
        req = st.request
        # no slab slot held hostage across the requeue wait: re-admission
        # acquires again, possibly paging the adapter back in
        self._release_adapter(req)
        req.resume_tokens = list(st.tokens)
        req.preemptions += 1
        req.resume_polls = st.decode_polls
        req.preempted_t = time.perf_counter()
        self._queue.appendleft(req)
        self._preempt_count += 1
        _telemetry.counter("serving.preemptions").inc()
        _telemetry.event("serving.request.preempt", id=req.request_id,
                         tokens=len(st.tokens), blocks_freed=len(st.blocks))

    def _ensure_tail_blocks(self) -> None:
        """Map a block for every live lane's next write now; on pool
        exhaustion preempt the youngest live request, repeatedly, until
        the allocation succeeds or the needy lane itself was evicted."""
        mb = self._tables.shape[1]
        for slot in list(self._pool.active):
            st = self._slots[slot]
            if st is None:                      # preempted this pass
                continue
            need = min(-(-(st.cache_len + 1) // self.block_size), mb)
            while self._slots[slot] is st and len(st.blocks) < need:
                blk = self._mgr.alloc()
                if blk is not None:
                    self._tables[slot, len(st.blocks)] = blk
                    st.blocks.append(blk)
                    self._blocks_hw = max(self._blocks_hw,
                                          self._mgr.n_in_use)
                    continue
                self._preempt(self._youngest_slot())

    def _decode_once(self) -> List[Response]:
        """One decode step over every lane (live ones advance, free ones
        ride along frozen)."""
        if self._mgr is not None:
            self._ensure_tail_blocks()
            if not self._pool.n_active:        # everything preempted
                return []
        active = np.asarray([st is not None for st in self._slots])
        t0 = time.perf_counter()
        dev = self.device
        with compile_label("serving.decode"):
            cache = self.cache
            if self._mgr is not None:
                cache = dict(cache, block_tables=torch.as_tensor(
                    self._tables, device=dev))
            prev_pos = self.cache["pos"]
            lora = None
            if self._adapters is not None:
                # every step of an engine with a pool, whatever the mix:
                # slot-0 lanes sit outside the grouped matmul's window
                lora = {"idx": torch.as_tensor(self._lane_slab, device=dev),
                        "slabs": self._adapters.slabs()}
            logits, new = decode_step(
                self.params, torch.as_tensor(self._pending, device=dev),
                cache, self.cfg, lora=lora, device=dev,
                backend=self.backend)
            self.cache["pos"] = torch.where(
                torch.as_tensor(active, device=dev), new["pos"], prev_pos)
            nxt_host = self._sample(logits, self._temps).cpu().numpy()
        dt = time.perf_counter() - t0
        _telemetry.counter("serving.decode_steps").inc()
        self._decode_count += 1
        if self._decode_count % 64 == 0 and _telemetry.enabled():
            sample_device_memory()
        completed = []
        emitted = 0
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            st.decode_polls += 1
            tok = int(nxt_host[slot])
            st.cache_len += 1
            st.tokens.append(tok)
            self._pending[slot] = tok
            emitted += 1
            done = self._finish_reason(st, tok)
            if done:
                completed.append(self._complete(slot, done))
        _telemetry.counter("serving.tokens_generated").inc(emitted)
        if dt > 0:
            _telemetry.gauge("serving.decode_tokens_per_sec").set(
                emitted / dt)
        return completed

    def _finish_reason(self, st: _Slot, tok: int) -> Optional[str]:
        eos = st.request.eos_token_id
        if eos is not None and tok == eos:
            return "eos"
        if len(st.tokens) >= st.request.max_new_tokens:
            return "length"
        return None

    def _complete(self, slot: int, reason: str) -> Response:
        st = self._slots[slot]
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._lane_slab[slot] = 0
        if self._mgr is not None:
            self._tables[slot, :] = self.num_blocks
            self._mgr.free_all(st.blocks)
        self._pool.release(slot)
        req = st.request
        self._release_adapter(req)
        now = time.perf_counter()
        latency_ms = (now - req.submitted_t) * 1e3
        queue_wait_ms = req.queue_wait_s * 1e3
        ttft_ms = (req.first_token_t - req.submitted_t) * 1e3
        tpot_ms = _tpot_ms(req.first_token_t, now, len(st.tokens))
        overhead_ms = req.preempt_overhead_s * 1e3
        tags = {"slo_class": req.slo_class}
        _telemetry.sketch("serving.queue_wait_ms", tags).observe(
            queue_wait_ms)
        _telemetry.sketch("serving.ttft_ms", tags).observe(ttft_ms)
        if tpot_ms is not None:
            _telemetry.sketch("serving.tpot_ms", tags).observe(tpot_ms)
        _telemetry.sketch("serving.e2e_ms", tags).observe(latency_ms)
        if req.preemptions:
            _telemetry.sketch("serving.preempt_overhead_ms", tags).observe(
                overhead_ms)
        met = _judge_slo(self._slo_targets.get(req.slo_class), ttft_ms,
                         tpot_ms)
        _telemetry.counter(
            "serving.goodput.met" if met else "serving.goodput.missed",
            tags).inc()
        _telemetry.histogram("serving.request_ms").observe(latency_ms)
        end = dict(id=req.request_id, finish_reason=reason,
                   tokens=len(st.tokens), latency_ms=round(latency_ms, 3),
                   slo_class=req.slo_class,
                   queue_wait_ms=round(queue_wait_ms, 3),
                   ttft_ms=round(ttft_ms, 3), preemptions=req.preemptions,
                   preempt_overhead_ms=round(overhead_ms, 3), slo_met=met)
        if tpot_ms is not None:
            end["tpot_ms"] = round(tpot_ms, 4)
        _telemetry.event("serving.request.end", **end)
        return Response(
            request_id=req.request_id, prompt=req.prompt,
            tokens=np.asarray(st.tokens, np.int32), finish_reason=reason,
            prefill_ms=st.prefill_ms, decode_steps=st.decode_polls,
            slo_class=req.slo_class, queue_wait_ms=queue_wait_ms,
            ttft_ms=ttft_ms, tpot_ms=tpot_ms or 0.0, e2e_ms=latency_ms,
            preemptions=req.preemptions, preempt_overhead_ms=overhead_ms,
            slo_met=met)
