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

Chunked prefill: with ``chunk_tokens=``, a prompt longer than one chunk
claims its lane and blocks at admission and then streams its prefill one
``chunk_tokens`` forward per :meth:`ServingEngine.step` (each chunk one
:func:`~apex_tpu_torch.models.generate.decode_verify` against the lane's
cache), interleaved with the other lanes' decode; its first token comes
from the final chunk.  Chunk-written blocks publish under the chunk
digest namespace (``paged_cache.chunk_salt``) and share only whole
leading chunks.

Constrained decoding: with ``token_masks=True``,
``submit(token_mask_fn=)`` gives a request a boolean vocabulary mask
applied before temperature, top-k and top-p at every sampling site (the
first token, and kernel K4 or the argmax at every decode step).

The compiled ladder: with ``compile_cache_dir=``, every ladder entry —
``prefill[bucket]`` and ``insert[bucket]`` per prompt bucket,
``decode``, ``sample`` and ``chunk`` — runs through
:class:`~apex_tpu_torch.serving.compile_cache.CompileCache`: on the card
each is captured once as a CUDA graph and replayed, over kernel libraries
kept in the directory (a primed directory starts with no ``nvcc`` run).
Each step's inputs (tokens, block tables, lanes, temperatures, key words)
are copied into the graphs' static buffers; the one host sync a step is
the read of the sampled tokens.  Without a directory the same entry
functions run eagerly, so the two engines launch the same kernels in the
same order.  :func:`~apex_tpu_torch.serving.compile_cache.warmup_ladder`
primes every entry.  The first token of a request is drawn eagerly (one
b=1 call per admission, outside the ladder), and so is a LoRA prompt's
prefill.

Speculative decoding: with ``spec=`` (``"ngram"`` or a
:class:`~apex_tpu_torch.models.speculative.SpecConfig`) each decode step
is one :func:`~apex_tpu_torch.models.speculative.spec_round` over every
lane: each live lane drafts k tokens from its own history (kept on the
device, across preempt → resume), one batched verify forward scores all
lanes' drafts, and each delivers 1 to k+1 tokens; EOS and budget
truncation stay on the host, and a truncated lane completes in that
step.  Paged budgets reserve the k+1-cell write horizon.  Under the
compiled ladder the round is the ``decode`` entry, one CUDA graph.

The host-DRAM tier: with ``host_tier_bytes=`` (paged only) a
:class:`~apex_tpu_torch.serving.host_tier.HostTier` parks a preempted
lane's pages (resume pages them back in through the ``insert[bucket]``
entry instead of replaying its prefill) and the pages of a published
block whose last HBM reference drops (raw wire only; a later admission
whose digest misses HBM pages it back in and republishes it).
``host_tier_wire="int8"`` parks preempted pages four times denser, at
the cost of bitwise resumes.

Differences from the JAX engine: pools are updated in place; sampling
draws its key words from a ``torch.Generator`` (``generator=``), so
sampled lanes are reproducible per seed but not the JAX tokens (greedy
lanes are the identity contract); no environment variable overrides
``chunk_tokens``, ``host_tier_bytes`` or ``host_tier_wire``; a capture
or replay failure raises instead of falling back.

The cluster tier's halves: :meth:`ServingEngine.submit_prefilled` queues
a request whose prefill ran elsewhere (a decoded KV handoff, injected at
admission through the same ``insert[bucket]`` entry prefill uses, so a
raw-wire handoff decodes token-identically), and
:meth:`ServingEngine.drain` pops every request out of the engine as
migration records (live lanes with their K/V) and plain requests to
requeue.

Telemetry (no-op unless :func:`~apex_tpu_torch.observability.configure`
ran) uses the JAX engine's names: ``serving.{requests,prefill_calls,
decode_steps,tokens_generated,preemptions}`` counters, occupancy, queue
and block gauges, per-class ``serving.{queue_wait_ms,ttft_ms,tpot_ms,
e2e_ms,preempt_overhead_ms}`` sketches, ``serving.goodput.{met,
missed}``, ``serving.adapter.requests{adapter=}``, ``serving.kv_injected`` and
``serving.kv_inject_ms`` for handoffs, ``serving.drained``, under
``spec=`` the
``generate.spec.{draft_tokens,accepted_tokens,verify_calls}`` counters,
and with the host tier ``serving.host_tier.{page_ins,resumes,replays}``
beside the tier's own metrics.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.generate import (
    _check_decode_cfg, _compute_dtype_params, decode_step, decode_verify,
    extract_kv, init_kv_cache, prefill)
from apex_tpu_torch.models.speculative import resolve_spec, spec_round
from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.observability import span
from apex_tpu_torch.observability.device import (
    compile_label, sample_device_memory)
from apex_tpu_torch.models.quantized import is_quantized_tree
from apex_tpu_torch.ops import (
    decode_step as _k3, dense as _k10, flash_attention as _k2,
    fused_sampling as _k4, grouped_matmul as _k9, layer_norm as _k1,
    paged_attention as _k6)
from apex_tpu_torch.ops.fused_sampling import _seed_words, fused_sample
from apex_tpu_torch.serving.batching import (
    SlotPool, default_buckets, pad_prompt, pick_bucket)
from apex_tpu_torch.serving.compile_cache import CompileCache
from apex_tpu_torch.serving.host_tier import (
    DIGEST_INVENTORY_N, HostTier, resolve_host_tier_bytes,
    resolve_host_tier_wire)
from apex_tpu_torch.serving.paged_cache import (
    BlockManager, blocks_for, chunk_salt, dequantize_kv, gather_block_kv,
    gather_block_scales, init_paged_pool, paged_insert_prefill,
    paged_insert_prefill_q, prefix_block_hashes, resolve_cache_wire)
from apex_tpu_torch.serving.slo import judge as _judge_slo
from apex_tpu_torch.serving.slo import resolve_slo_targets
from apex_tpu_torch.serving.slo import tpot_ms as _tpot_ms
from apex_tpu_torch.utils.registry import check_backend, resolve_device

__all__ = ["Request", "Response", "ServingEngine"]


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
    # constrained decoding: boolean [vocab] mask, True = allowed, applied
    # before temperature / top-k / top-p at every sampling site
    token_mask: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
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
    # a cluster KV handoff (submit_prefilled): (k, v, first_token,
    # prefill_ms) with per-token K/V [L, n, g, dh] on the host; admission
    # injects it instead of running a prefill, and a preemption drops it
    # (resume replays through the local prefill, which reproduces a
    # raw-wire handoff's K/V bit for bit)
    handoff: Optional[tuple] = dataclasses.field(default=None, repr=False)
    # a raw-wire handoff of fresh prefill pages is bitwise what a local
    # flash prefill writes, so it may map and publish flash-namespace
    # digests; every other handoff claims fresh, private blocks
    handoff_shareable: bool = False

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
        if self.token_mask is not None:
            self.token_mask = np.asarray(self.token_mask, bool).reshape(-1)
            if not self.token_mask.any():
                raise ValueError(
                    "token_mask allows no tokens — sampling would "
                    "degenerate to argmax over -inf")


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
    # chunked prefill: a lane admitted for a long prompt streams its
    # prefill one chunk per step and joins the decode batch after the
    # last; while prefilling, cache_len is the tokens written so far
    prefilling: bool = False
    chunks_done: int = 0
    chunks_total: int = 0
    prefill_tokens: Optional[np.ndarray] = None
    # the prompt's chunk-namespace digests and how many leading blocks
    # are published (shared blocks count as published at admission)
    digests: Optional[List[bytes]] = None
    published_upto: int = 0


def _resolve_chunk_tokens(value: Optional[int]) -> Optional[int]:
    """The chunked-prefill knob: a positive chunk size, or None for
    monolithic prefill (the JAX engine's environment override is not
    ported: nothing in the port routes by environment)."""
    if value is not None and int(value) < 1:
        raise ValueError(
            f"chunk_tokens={value} must be >= 1 (or None for "
            "monolithic prefill)")
    return None if value is None else int(value)


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
    ``cache_dtype`` stores a native pool in another float dtype than the
    compute dtype (e.g. bf16 under fp32 compute); rows 6 and 7 read it as
    it is.  ``generator`` (a CPU ``torch.Generator``, default seeded 0)
    keys the sampled lanes.  ``adapter_pool`` serves LoRA adapters,
    ``chunk_tokens`` turns on chunked prefill, ``token_masks=True``
    constrained decoding, ``spec`` speculative decoding,
    ``host_tier_bytes``/``host_tier_wire`` the host-DRAM tier, and
    ``compile_cache_dir`` the compiled ladder (module doc).  ``device``
    defaults to ``cuda``; ``backend="reference"`` pins every op to its
    plain version (tests and ``chip_smoke.py``)."""

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
        _check_decode_cfg(cfg)
        # speculative decoding: _spec_ahead is the KV write horizon a step
        # may touch past a lane's materialized length (the pending token
        # plus k drafts), which sizes tail allocation and the solo budget
        self._spec = resolve_spec(spec)
        self._spec_ahead = 1 if self._spec is None else self._spec.k + 1
        self.chunk_tokens = _resolve_chunk_tokens(chunk_tokens)
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
            # the host-DRAM tier behind the block ledger
            hb = resolve_host_tier_bytes(host_tier_bytes)
            self._host = (HostTier(
                hb, wire=resolve_host_tier_wire(host_tier_wire),
                block_size=self.block_size) if hb else None)
        else:
            if resolve_host_tier_bytes(host_tier_bytes):
                raise ValueError(
                    "host_tier_bytes needs cache_layout='paged' — the "
                    "offload tier parks paged blocks")
            self._host = None
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
        # spec only: each lane's emitted history (prompt + generated,
        # pending token included), the drafter's haystack, on the device;
        # the decode step appends its delivered tokens in place, so only
        # admissions write a row from the host.  One column past max_len
        # takes the writes that drop.
        self._history = self._hist_len = None
        if self._spec is not None:
            self._history = torch.zeros((self.max_slots, self.max_len + 1),
                                        dtype=torch.int32, device=dev)
            self._hist_len = torch.zeros((self.max_slots,), dtype=torch.int32,
                                         device=dev)
        # the adapter pool and the per-lane slab index (0 = base), a host
        # mirror uploaded each step like _pending and _temps
        self._adapters = adapter_pool
        self._lane_slab = np.zeros((self.max_slots,), np.int32)
        self._next_id = 0
        # the latest decode step's logits [max_slots, v] (on the card under
        # a compile cache: the decode graph's output, valid until the next
        # step)
        self.last_logits: Optional[torch.Tensor] = None
        self._decode_count = 0
        self._prefill_count = 0
        self._preempt_count = 0
        self._sampling = dict(top_k=top_k, top_p=top_p,
                              vocab_limit=vocab_limit)
        self._slo_targets = resolve_slo_targets(slo_targets)
        # constrained decoding: per-lane allow rows, a host mirror and the
        # device copy the decode and sample entries read (rows are
        # rewritten at slot handoff only)
        self._masks = self._mask_dev = None
        if token_masks:
            self._masks = np.ones((self.max_slots, cfg.vocab_size), bool)
            self._mask_dev = torch.ones((self.max_slots, cfg.vocab_size),
                                        dtype=torch.bool, device=dev)
        # the compiled ladder; its kernel libraries live in the directory
        self._compile_cache = None
        # each ladder entry after its first lookup: the engine's bound
        # state never changes, so a step calls its entry directly
        self._entries: dict = {}
        if compile_cache_dir:
            self._compile_cache = CompileCache(compile_cache_dir, device=dev)

    # -- public API --------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               slo_class: str = "default", adapter_id: int = 0,
               token_mask_fn=None) -> int:
        """Queue one request; returns its request id.  ``adapter_id``
        selects an adapter registered on the engine's pool (0 = base
        model).  ``token_mask_fn`` (an engine built with
        ``token_masks=True``) is called once with the vocabulary size and
        returns a boolean ``[vocab]`` allow mask or the allowed token
        ids."""
        if adapter_id:
            if self._adapters is None:
                raise ValueError(
                    f"adapter_id={adapter_id} but the engine has no "
                    "adapter_pool — pass adapter_pool= at construction")
            if not self._adapters.registered(adapter_id):
                raise ValueError(
                    f"adapter_id={adapter_id} is not registered on the "
                    "engine's adapter pool")
        token_mask = None
        if token_mask_fn is not None:
            if self._masks is None:
                raise ValueError(
                    "token_mask_fn= needs token_masks=True at engine "
                    "construction (the step gains a mask operand)")
            m = np.asarray(token_mask_fn(self.cfg.vocab_size))
            if m.dtype != np.bool_:
                ids = m.astype(np.int64).reshape(-1)
                m = np.zeros((self.cfg.vocab_size,), bool)
                m[ids] = True
            if m.shape != (self.cfg.vocab_size,):
                raise ValueError(
                    f"token_mask_fn returned shape {m.shape}; expected "
                    f"({self.cfg.vocab_size},) or a list of token ids")
            token_mask = m
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=self._next_id, slo_class=str(slo_class),
                      adapter_id=int(adapter_id), token_mask=token_mask)
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

    def submit_prefilled(self, prompt, k, v, first_token: int, *,
                         max_new_tokens: int = 32,
                         temperature: float = 0.0,
                         eos_token_id: Optional[int] = None,
                         slo_class: str = "default",
                         prefill_ms: float = 0.0,
                         shareable: bool = False,
                         adapter_id: int = 0) -> int:
        """Queue a request whose prefill already happened elsewhere: the
        decode half of prefill/decode disaggregation.

        ``k``/``v`` are the prompt's per-token K/V ``[L, len(prompt),
        kv_groups, dh]`` (a decoded cluster handoff,
        :func:`~apex_tpu_torch.serving.cluster.handoff.decode_kv`, or a
        :meth:`drain` record) and ``first_token`` the token the remote
        prefill sampled.  Admission writes the K/V into this engine's
        cache through the ``insert[bucket]`` entry prefill uses (paged:
        fresh blocks; contiguous: the slot stripe) and the lane decodes
        on; for a raw-wire handoff between same-dtype caches greedy
        continuation is token-identical to having prefilled here.
        ``prefill_ms`` (the remote measurement) is carried onto the
        Response.

        Injected blocks are private by default: wire-derived pages must
        not alias the digests of locally computed ones.
        ``shareable=True`` opts a raw-wire handoff of fresh prefill pages
        into the flash digest namespace (it maps published prefix blocks
        and publishes its own full blocks); the caller, which reads the
        handoff header, owns that judgment.  A preempted handoff is
        dropped and resumes through the local prefill.

        ``adapter_id``: the adapter the remote prefill ran through;
        decode folds the same delta.  Adapter handoffs are never
        shareable."""
        if adapter_id:
            if self._adapters is None:
                raise ValueError(
                    f"adapter_id={adapter_id} but the engine has no "
                    "adapter_pool — pass adapter_pool= at construction")
            if not self._adapters.registered(adapter_id):
                raise ValueError(
                    f"adapter_id={adapter_id} is not registered on the "
                    "engine's adapter pool")
            shareable = False
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
        k = torch.as_tensor(k).detach().cpu()
        v = torch.as_tensor(v).detach().cpu()
        want = (self.cfg.num_layers, req.prompt.size, self.cfg.kv_groups,
                self.cfg.kv_channels)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"handoff K/V shape {tuple(k.shape)}/{tuple(v.shape)} does "
                f"not match this engine's cache geometry {want} — refusing "
                "to reinterpret a foreign handoff")
        req.handoff = (k, v, int(first_token), float(prefill_ms))
        req.handoff_shareable = bool(shareable)
        if self._mgr is not None and req.handoff_shareable:
            self._admission_state(req)      # digests once, at submit
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
                         slo_class=req.slo_class, injected=True)
        self._set_gauges()
        return req.request_id

    def drain(self) -> Tuple[List[dict], List[Request]]:
        """Pop EVERY request out of the engine → ``(live, requeue)``,
        leaving it idle (lossless scale-down).

        ``live`` holds one record per decoding lane, everything a
        survivor engine needs to continue the request exactly where it
        stopped: the token sequence the cache materialized (prompt +
        generated minus the pending token) as ``prompt``, the pending
        token as ``first_token``, the remaining budget, and the per-token
        K/V (``k``/``v`` ``[L, n, g, dh]`` on the host, through
        :func:`~apex_tpu_torch.models.generate.extract_kv`; an int8 pool
        dequantizes).  Feeding a record into another engine's
        :meth:`submit_prefilled` continues greedy token-identically.

        ``requeue`` holds the requests with nothing to migrate (the
        queue, and lanes still mid-chunked-prefill) as plain
        :class:`Request` objects ready for re-submission."""
        live: List[dict] = []
        requeue: List[Request] = []
        cache = self.cache
        if self._mgr is not None:
            # one table upload for the whole drain: the ledger does not
            # change until after extraction
            cache = dict(self.cache, block_tables=torch.from_numpy(
                self._tables.copy()).to(self.device))
        for slot in sorted(self._pool.active,
                           key=lambda s: self._slots[s].request.request_id):
            st = self._slots[slot]
            req = st.request
            migrated = not st.prefilling and bool(st.tokens)
            if migrated:
                k, v = extract_kv(cache, st.cache_len, row=slot)
                live.append({
                    "engine_rid": req.request_id,
                    "prompt": np.concatenate(
                        [req.prompt, np.asarray(st.tokens[:-1], np.int32)]),
                    "orig_prompt_len": int(req.prompt.size),
                    "done_tokens": list(st.tokens),
                    "first_token": int(st.tokens[-1]),
                    "max_new_tokens": (req.max_new_tokens
                                       - len(st.tokens) + 1),
                    "temperature": req.temperature,
                    "eos_token_id": req.eos_token_id,
                    "slo_class": req.slo_class,
                    "preemptions": req.preemptions,
                    "decode_polls": st.decode_polls,
                    "prefill_ms": st.prefill_ms,
                    "adapter_id": req.adapter_id,
                    "k": k.cpu(),
                    "v": v.cpu(),
                })
            else:
                requeue.append(req)
            self._release_adapter(req)
            self._slots[slot] = None
            self._pending[slot] = 0
            self._temps[slot] = 0.0
            self._lane_slab[slot] = 0
            if self._mgr is not None:
                self._tables[slot, :] = self.num_blocks
                self._mgr.free_all(st.blocks)
            self._pool.release(slot)
            _telemetry.counter("serving.drained").inc()
            _telemetry.event("serving.request.drained", id=req.request_id,
                             migrated=migrated)
        while self._queue:
            req = self._queue.popleft()
            req.handoff = None     # its wire pages die with this engine
            requeue.append(req)
            _telemetry.counter("serving.drained").inc()
        self._set_gauges()
        return live, requeue

    def _check_pool_budget(self, req: Request) -> None:
        """Reject a request that could never complete even alone."""
        if self._mgr is None:
            return
        # a verify block writes up to k cells past the materialized length
        # before its rejected tail rolls back: the solo worst case covers
        # them (clamped to the table's reach)
        horizon = min(req.prompt.size + req.max_new_tokens
                      + (self._spec_ahead - 1),
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
        """Admit what fits, run one prefill chunk if a lane is mid-prefill,
        decode one token for every live lane; returns the requests
        completed by this step."""
        completed = self._admit()
        # the queue detector's one valid sampling point: after admission,
        # before decode frees slots that the next step's admission fills
        self._feed_queue_detector()
        if self.chunk_tokens:
            completed.extend(self._prefill_chunk_once())
        if any(st is not None and not st.prefilling for st in self._slots):
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
        """Engine state snapshot (the JAX engine's keys, plus
        ``decode_steps`` and ``prefill_calls``)."""
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
            "spec_k": None if self._spec is None else self._spec.k,
            "chunk_tokens": self.chunk_tokens,
            "prefilling": sum(1 for st in self._slots
                              if st is not None and st.prefilling),
            "compile_cache": (None if self._compile_cache is None
                              else self._compile_cache.stats()),
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
                    "chunk_tokens": self.chunk_tokens,
                    "hbm": [h.hex()[:16] for h in
                            self._mgr.newest_digests(DIGEST_INVENTORY_N)],
                    "host": ([h.hex()[:16]
                              for h in self._host.newest_digests()]
                             if self._host is not None else []),
                },
            })
            if self._host is not None:
                out["host_tier"] = self._host.stats()
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

    def _feed_queue_detector(self) -> None:
        reg = _telemetry.registry()
        if reg is not None and reg.detectors is not None:
            reg.detectors.feed_serving(
                len(self._queue), self._pool.n_active / self.max_slots)

    # -- admission ---------------------------------------------------------

    def _admission_state(self, req: Request):
        """(full token array, prefix digests) of the request's current
        resume state, memoized on the Request; a chunked admission's
        digests live in the chunk namespace."""
        n = req.prompt.size + len(req.resume_tokens)
        salt = chunk_salt(self.chunk_tokens) if self._chunked(req) else b""
        if (req._hash_cache is None or req._hash_cache[0] != n
                or req._hash_cache[1] != salt):
            tokens = self._full_tokens(req)
            full = n // self.block_size
            req._hash_cache = (n, salt, tokens, prefix_block_hashes(
                tokens[: full * self.block_size], self.block_size,
                salt=salt))
        return req._hash_cache[2], req._hash_cache[3]

    def _chunked(self, req: Request) -> bool:
        """Whether the request admits through chunked prefill: a prompt
        longer than one chunk, not a KV handoff (its pages come off the
        wire), not an adapter request (its prefill is one LoRA verify
        forward)."""
        if (not self.chunk_tokens or req.handoff is not None
                or req.adapter_id):
            return False
        return req.prompt.size + len(req.resume_tokens) > self.chunk_tokens

    def _host_resumable(self, req: Request) -> bool:
        """Whether this admission pages its K/V back in from the host tier
        instead of running a prefill: a preempted request whose
        materialized pages (prompt + generated - 1 tokens: the pending
        token's K/V was never written) are still parked."""
        return (self._host is not None and req.handoff is None
                and bool(req.resume_tokens)
                and self._host.has_request(
                    req.request_id,
                    req.prompt.size + len(req.resume_tokens) - 1))

    def _chunk_share_plan(self, n: int, hashes: List[bytes]) -> int:
        """How many leading full blocks of a chunked admission map (HBM) or
        page in (host tier) published chunk-namespace digests instead of
        running their chunks: whole chunks only (a sharer starts its chunk
        grid where the producer did), none unless ``chunk_tokens %
        block_size == 0``, and never the final chunk (it samples the first
        token)."""
        ct, bs = self.chunk_tokens, self.block_size
        if ct % bs:
            return 0
        bpc = ct // bs
        lead = 0
        for c in range(min(n // ct, -(-n // ct) - 1)):
            chunk_hashes = hashes[c * bpc:(c + 1) * bpc]
            if len(chunk_hashes) < bpc or not all(
                    self._mgr.lookup_prefix(h) is not None
                    or (self._host is not None and self._host.has_block(h))
                    for h in chunk_hashes):
                break
            lead += bpc
        return lead

    def _blocks_needed(self, req: Request) -> int:
        """NEW blocks the request must allocate at admission (published
        prefix hits map, they do not allocate; host-tier digest hits
        allocate and page in; a page-in resume covers its materialized
        ``n - 1`` tokens fresh, a KV handoff all ``n`` unless it is
        shareable; a chunked admission maps only its leading shared
        chunks)."""
        n = req.prompt.size + len(req.resume_tokens)
        if self._host_resumable(req):
            return blocks_for(n - 1, self.block_size)
        if req.handoff is not None and not req.handoff_shareable:
            return blocks_for(n, self.block_size)
        _tokens, hashes = self._admission_state(req)
        need = blocks_for(n, self.block_size)
        if self._chunked(req):
            hashes = hashes[: self._chunk_share_plan(n, hashes)]
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
                # wait for completions or a preemption; meanwhile decode
                # the head's parked pages, so its page-in does not wait
                if (self._host is not None and req.resume_tokens
                        and req.handoff is None):
                    self._host.prefetch_request(
                        req.request_id,
                        req.prompt.size + len(req.resume_tokens) - 1)
                break
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
        """Stamp the lane-local operands at slot handoff: the adapter slab
        index (every teardown edge resets it) and, with constrained
        decoding, the request's mask row."""
        self._lane_slab[slot] = req._lane
        if self._masks is not None:
            row = (req.token_mask if req.token_mask is not None
                   else np.ones((self.cfg.vocab_size,), bool))
            if not np.array_equal(self._masks[slot], row):
                self._masks[slot] = row
                self._mask_dev[slot].copy_(torch.from_numpy(row))

    def _mask_arg(self, req: Request):
        """The request's mask for its first-token draw: None when it has
        none (an all-True row changes nothing)."""
        if self._masks is None or req.token_mask is None:
            return None
        return torch.from_numpy(req.token_mask).to(self.device)

    def _claim_blocks(self, tokens: np.ndarray, hashes: List[bytes]):
        """Map/allocate the block list for ``tokens``: published full
        blocks are shared (not rewritten); a digest parked in the host
        tier allocates, publishes and pages in (not rewritten: the raw
        host wire restores what the prefill would write); the rest
        allocate, full ones publish.  Returns (blocks, write_ids,
        shared_count, page_ins), ``page_ins`` ``[(block, (k, v))]`` for
        :meth:`_page_in_blocks`; raises on exhaustion with everything
        unwound."""
        blocks: List[int] = []
        write_ids: List[int] = []
        page_ins: List[tuple] = []
        shared = 0
        try:
            for h in hashes:
                blk = self._mgr.share_prefix(h)
                if blk is not None:
                    blocks.append(blk)
                    write_ids.append(self.num_blocks)   # don't rewrite
                    shared += 1
                    continue
                hit = None
                if self._host is not None and self._host.has_block(h):
                    # has_block first: only parked digests count a hit
                    hit = self._host.peek_block(h)
                blk = self._mgr.alloc()
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                self._mgr.publish_prefix(h, blk)
                blocks.append(blk)
                if hit is not None:
                    write_ids.append(self.num_blocks)   # the page-in writes
                    page_ins.append((blk, hit))
                else:
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
        return blocks, write_ids, shared, page_ins

    def _page_in_blocks(self, slot: int, page_ins: List[tuple]) -> None:
        """Scatter host-tier digest pages into their freshly published
        blocks through one ``insert`` call of a bucket of the next power
        of two blocks (an int8 pool requantizes on the way, as a prefill
        write does).  The lane position the insert stamps is re-stamped by
        every caller."""
        if not page_ins:
            return
        t0 = time.perf_counter()
        bs = self.block_size
        L, g, dh = (self.cfg.num_layers, self.cfg.kv_groups,
                    self.cfg.kv_channels)
        m = len(page_ins)
        cap = 1
        while cap < m:
            cap *= 2
        bucket = cap * bs
        ks = torch.zeros((L, 1, bucket, g, dh), dtype=self._cache_dtype)
        vs = torch.zeros_like(ks)
        for i, (_blk, (k, v)) in enumerate(page_ins):
            ks[:, 0, i * bs:(i + 1) * bs] = k.to(self._cache_dtype)
            vs[:, 0, i * bs:(i + 1) * bs] = v.to(self._cache_dtype)
        self._insert_prefill_kv(slot, bucket, [blk for blk, _kv in page_ins],
                                ks, vs, m * bs)
        _telemetry.counter("serving.host_tier.page_ins").inc(m)
        _telemetry.sketch("serving.host_tier.page_in_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    def _spec_history(self, slot: int, tokens: np.ndarray,
                      pending: Optional[int]) -> None:
        """Write lane ``slot``'s drafting history (spec only): ``tokens``,
        then the pending token when it is not among them."""
        if self._spec is None:
            return
        row = np.zeros((self.max_len + 1,), np.int32)
        n = int(tokens.size)
        row[:n] = tokens
        if pending is not None:
            row[n] = pending
            n += 1
        self._history[slot].copy_(torch.from_numpy(row))
        self._hist_len[slot] = n

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

    # -- the ladder: every entry runs through _cc ---------------------------

    def _cc_parts(self, **extra) -> dict:
        """The static identity every ladder entry's key carries (the shapes
        and the code digest are added by the cache)."""
        spec = self._spec
        return dict(cache_wire=self.cache_wire,
                    cache_layout=self.cache_layout,
                    chunk_tokens=self.chunk_tokens,
                    spec=None if spec is None else (
                        spec.k, spec.max_ngram, spec.min_ngram,
                        getattr(spec.draft_fn, "__qualname__", None)),
                    sampling=tuple(sorted(self._sampling.items())),
                    lora=self._adapters is not None,
                    masked=self._masks is not None, backend=self.backend,
                    **extra)

    def _cc(self, name: str, fn, args: tuple, bound, **parts):
        """One ladder call: through the compile cache when the engine has
        one (on the card a captured graph; a capture or replay failure
        raises), else ``fn`` eagerly on the same inputs.  ``bound`` is a
        function returning the entry's bound state, called at the entry's
        first lookup only (and at every eager call)."""
        if self._compile_cache is None:
            return fn(*(a.to(self.device) for a in args), **bound())
        key = (name, tuple(sorted(parts.items())),
               tuple((a.shape, a.dtype) for a in args))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._compile_cache.load_or_compile(
                name, fn, args, bound(), key_parts=self._cc_parts(**parts))
        return entry(*args)

    def _ladder_sources(self) -> List[str]:
        """The kernel sources this engine's ladder entries launch: K1 and
        K2 (prefill), K4 (sample), K3 on float weights without LoRA else
        row 6 (decode), row 10 on quantized weights, row 9 with LoRA.
        Under ``spec`` the decode entry is a verify forward (K1 and the
        matmuls; its attention is torch arithmetic) and there is no
        ``sample`` entry."""
        ks = [_k1.LN_FWD, _k2.FLASH_FWD]
        quant = is_quantized_tree(self.params)
        if self._spec is None:
            ks.append(_k4.FUSED_SAMPLE)
            if quant or self._adapters is not None:
                ks.append(_k6.PAGED_ATTENTION)
            else:
                ks.append(_k3.DECODE_LAYER)
        if quant:
            ks.append(_k10.DENSE_INT8)
        if self._adapters is not None:
            ks.append(_k9.GROUPED_MATMUL)
        return sorted({k.source for k in ks})

    def _pools(self) -> dict:
        return {k: v for k, v in self.cache.items() if k != "pos"}

    def _prefill_call(self, tokens: np.ndarray, n: int, bucket: int):
        """``prefill[bucket]``: → (last-token logits ``[1, v]``, the bucket
        cache's K and V ``[L, 1, bucket, g, dh]``)."""
        args = (torch.from_numpy(pad_prompt(tokens, bucket)[None]).long(),
                torch.tensor([n], dtype=torch.int32))
        return self._cc("prefill", _prefill_entry, args, lambda: dict(
            params=self.params, cfg=self.cfg, bucket=bucket,
            cache_dtype=self._cache_dtype, backend=self.backend),
            bucket=bucket)

    def _insert_prefill_kv(self, slot: int, bucket: int,
                           write_ids: List[int], ks, vs, n: int) -> None:
        """``insert[bucket]``: write a bucket-sized prefill cache ``[L, 1,
        bucket, g, dh]`` into the lane's storage; then set its position
        to ``n``."""
        if self._mgr is not None:
            where = np.full((blocks_for(bucket, self.block_size),),
                            self.num_blocks, np.int32)
            where[: len(write_ids)] = write_ids
            where = torch.from_numpy(where)
        else:
            where = torch.tensor([slot], dtype=torch.long)
        self._cc("insert", _insert_entry,
                 (ks, vs, where, torch.tensor([n], dtype=torch.int32)),
                 lambda: dict(cache=self._pools(), layout=self.cache_layout,
                              bucket=bucket,
                              block_size=getattr(self, "block_size", None)),
                 bucket=bucket)
        self.cache["pos"][slot] = n

    def _decode_bound(self) -> dict:
        return dict(params=self.params, cache=self.cache, cfg=self.cfg,
                    paged=self._mgr is not None,
                    slabs=(None if self._adapters is None
                           else self._adapters.slabs()),
                    masks=self._mask_dev,
                    vocab_limit=self._sampling["vocab_limit"],
                    backend=self.backend)

    def _spec_bound(self) -> dict:
        return dict(params=self.params, cache=self.cache, cfg=self.cfg,
                    spec=self._spec, history=self._history,
                    hist_len=self._hist_len, paged=self._mgr is not None,
                    slabs=(None if self._adapters is None
                           else self._adapters.slabs()),
                    masks=self._mask_dev, backend=self.backend,
                    **self._sampling)

    def _decode_args(self, pending, active) -> list:
        """The decode entry's per-step inputs: pending tokens and the
        active mask (with spec, the temperatures and two key words), the
        block tables (paged), the LoRA lane ids (with a pool)."""
        args = [pending, active]
        if self._spec is not None:
            args += [torch.from_numpy(self._temps.copy()),
                     torch.tensor(_seed_words(self._gen), dtype=torch.int64)]
        if self._mgr is not None:
            args.append(torch.from_numpy(self._tables.copy()))
        if self._adapters is not None:
            # every step of an engine with a pool, whatever the mix:
            # slot-0 lanes sit outside the grouped matmul's window
            args.append(torch.from_numpy(self._lane_slab.copy()))
        return args

    def _sample_bound(self) -> dict:
        return dict(masks=self._mask_dev, backend=self.backend,
                    **self._sampling)

    def _chunk_call(self, where: torch.Tensor, chunk: np.ndarray, lo: int):
        """``chunk``: one ``chunk_tokens`` verify forward at position
        ``lo`` of the lane that ``where`` names (paged: its table row;
        contiguous: its slot) → logits ``[1, chunk_tokens, v]``."""
        return self._cc(
            "chunk", _chunk_entry,
            (torch.from_numpy(chunk), where,
             torch.tensor([lo], dtype=torch.int32)),
            lambda: dict(params=self.params, cache=self._pools(),
                         cfg=self.cfg, paged=self._mgr is not None,
                         backend=self.backend))

    def _ladder(self):
        """(label, call) for every ladder entry, on placeholder inputs that
        change nothing an idle engine holds: inserts drop every write
        (sentinel blocks, length 0) or land in a free stripe's head, the
        decode step's lanes are all inactive with sentinel tables, the
        chunk writes through sentinel blocks or a free stripe, and the
        sampler's key words are fixed (the engine's generator is not
        drawn)."""
        S = self.max_slots

        def prefill_and_insert(bucket, insert):
            _lg, ks, vs = self._prefill_call(np.zeros(1, np.int32), 1,
                                             bucket)
            if insert:
                pos = self.cache["pos"][0].clone()
                self._insert_prefill_kv(0, bucket, [], ks, vs, 0)
                self.cache["pos"][0] = pos

        def decode():
            args = [torch.zeros(S, dtype=torch.int32),
                    torch.zeros(S, dtype=torch.bool)]
            if self._spec is not None:
                # no lane active: the history and positions stay, the
                # verify writes drop (sentinel tables) or land past free
                # stripes' lengths
                args += [torch.zeros(S), torch.zeros(2, dtype=torch.long)]
            if self._mgr is not None:
                args.append(torch.full(self._tables.shape, self.num_blocks,
                                       dtype=torch.int32))
            if self._adapters is not None:
                args.append(torch.zeros(S, dtype=torch.int32))
            if self._spec is not None:
                return self._cc("decode", _spec_entry, tuple(args),
                                self._spec_bound)
            return self._cc("decode", _decode_entry, tuple(args),
                            self._decode_bound)

        def sample():
            # over the decode entry's logits, as a step feeds it
            logits, _greedy = decode()
            self._cc("sample", _sample_entry,
                     (logits, torch.ones(S), torch.zeros(2, dtype=torch.long)),
                     self._sample_bound)

        def chunk():
            where = (torch.full(self._tables.shape[1:], self.num_blocks,
                                dtype=torch.int32) if self._mgr is not None
                     else torch.tensor([0], dtype=torch.long))
            self._chunk_call(where, np.zeros(self.chunk_tokens, np.int32), 0)

        for b in self.buckets:
            yield f"prefill[{b}]", functools.partial(prefill_and_insert, b,
                                                     False)
            yield f"insert[{b}]", functools.partial(prefill_and_insert, b,
                                                    True)
        yield "decode", decode
        yield "sample", sample
        if self.chunk_tokens:
            yield "chunk", chunk

    def _ladder_skip(self, label: str) -> Optional[str]:
        """Why this engine cannot call a ladder entry now, or None."""
        if (label == "decode" and self._adapters is not None
                and not self._adapters._registry):
            return ("the adapter pool has no registered adapter, so the "
                    "decode step's slabs do not exist yet")
        if label == "sample" and self._spec is not None:
            return ("under spec= the decode entry draws inside its round "
                    "and first tokens are drawn eagerly")
        return None

    def _sample(self, logits, temps: np.ndarray,
                token_mask=None) -> torch.Tensor:
        """A first token (b=1, eagerly, outside the ladder): greedy is the
        masked argmax (no launch); otherwise one fused sampler call."""
        kw = self._sampling
        if not (temps > 0).any():
            return fused_sample(logits, temperature=0.0,
                                vocab_limit=kw["vocab_limit"],
                                token_mask=token_mask, backend=self.backend)
        t = torch.as_tensor(temps, dtype=torch.float32, device=self.device)
        return fused_sample(logits, generator=self._gen, temperature=t,
                            top_k=kw["top_k"], top_p=kw["top_p"],
                            vocab_limit=kw["vocab_limit"],
                            token_mask=token_mask, backend=self.backend)

    def _admit_one(self, req: Request, slot: int) -> List[Response]:
        """Prefill one claimed request into its lane (block allocations
        unwind here on failure).  A preempted request whose pages are
        still parked in the host tier pages them back in instead
        (:meth:`_admit_one_paged_in`), even where it would replay
        chunked.  A KV handoff (:meth:`submit_prefilled`) runs no prefill:
        its pages come off the wire, its first token from the remote
        sampler."""
        if (self._host is not None and req.handoff is None
                and req.resume_tokens):
            n_kv = req.prompt.size + len(req.resume_tokens) - 1
            kv = self._host.take_request(req.request_id, n_kv)
            if kv is not None:
                return self._admit_one_paged_in(req, slot, *kv)
            # evicted, or never fit: the replay half of resume-vs-replay
            _telemetry.counter("serving.host_tier.replays").inc()
        if self._chunked(req):
            return self._admit_one_chunked(req, slot)
        if req.adapter_id and req.handoff is None:
            # a handoff's pages come off the wire: only its decode needs
            # the adapter
            return self._admit_one_adapter(req, slot)
        completed: List[Response] = []
        hashes: List[bytes] = []
        shareable = (self._mgr is not None
                     and (req.handoff is None or req.handoff_shareable))
        if shareable:
            tokens, hashes = self._admission_state(req)
        else:
            tokens = self._full_tokens(req)
        n = int(tokens.size)
        bucket = pick_bucket(n, self.buckets)
        blocks: List[int] = []
        write_ids: List[int] = []
        page_ins: List[tuple] = []
        shared = 0
        if shareable:
            # prefills and shareable raw-wire handoffs map and publish
            # flash-namespace digests
            blocks, write_ids, shared, page_ins = self._claim_blocks(
                tokens, hashes)
        elif self._mgr is not None:
            blocks = self._claim_blocks_fresh(n)
            write_ids = list(blocks)
        t0 = time.perf_counter()
        if req.admitted_t == 0.0:
            req.admitted_t = t0
            req.queue_wait_s = t0 - req.submitted_t
        try:
            if page_ins:
                # host-parked digest pages first (blocks disjoint from the
                # prefill's writes; the insert below re-stamps pos)
                with span("serving.host_page_in"), \
                        compile_label("serving.prefill"):
                    self._page_in_blocks(slot, page_ins)
            if req.handoff is not None:
                with span("serving.kv_inject"), \
                        compile_label("serving.prefill"):
                    tok = self._inject_handoff(req, slot, bucket, write_ids,
                                               n)
            else:
                with span("serving.prefill"), \
                        compile_label("serving.prefill"):
                    logits, ks, vs = self._prefill_call(tokens, n, bucket)
                    self._insert_prefill_kv(slot, bucket, write_ids, ks, vs,
                                            n)
                    first = self._sample(
                        logits, np.asarray([req.temperature], np.float32),
                        self._mask_arg(req))
                    tok = int(first[0])                  # host sync
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
            if req.handoff is not None:
                # the prefill ran remotely: count the injection and carry
                # the remote prefill time onto the Response
                _telemetry.counter("serving.kv_injected").inc()
                _telemetry.histogram("serving.kv_inject_ms").observe(ms)
                ms = req.handoff[3]
            else:
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
        self._spec_history(slot, tokens, tok)
        done = self._finish_reason(st, tok)
        if done:
            completed.append(self._complete(slot, done))
        return completed

    def _inject_handoff(self, req: Request, slot: int, bucket: int,
                        write_ids: List[int], n: int) -> int:
        """Write a decoded KV handoff into the lane through the
        ``insert[bucket]`` entry prefill uses (so injection writes exactly
        what a local prefill would have) → the remotely sampled first
        token."""
        k, v, tok, _ms = req.handoff
        shape = (self.cfg.num_layers, 1, bucket, self.cfg.kv_groups,
                 self.cfg.kv_channels)
        ks = torch.zeros(shape, dtype=self._cache_dtype)
        vs = torch.zeros(shape, dtype=self._cache_dtype)
        ks[:, 0, :n] = k.to(self._cache_dtype)
        vs[:, 0, :n] = v.to(self._cache_dtype)
        self._insert_prefill_kv(slot, bucket, write_ids, ks, vs, n)
        return int(tok)

    def _admit_one_paged_in(self, req: Request, slot: int, k, v
                            ) -> List[Response]:
        """Re-admit a preempted request from its parked pages: fresh blocks
        (the pages hold decode-written tokens, never digest-shared), the
        K/V scattered back through the ``insert[bucket]`` entry, and the
        lane straight back into decode behind its pending token
        (``resume_tokens[-1]``, whose K/V the next step writes).  No
        prefill runs and no token is drawn; on the raw wire the round trip
        is bitwise, so greedy continuation is token-identical."""
        n_kv = req.prompt.size + len(req.resume_tokens) - 1
        bucket = pick_bucket(n_kv, self.buckets)
        blocks = self._claim_blocks_fresh(n_kv)
        t0 = time.perf_counter()
        try:
            with span("serving.host_page_in"), \
                    compile_label("serving.prefill"):
                shape = (self.cfg.num_layers, 1, bucket, self.cfg.kv_groups,
                         self.cfg.kv_channels)
                ks = torch.zeros(shape, dtype=self._cache_dtype)
                vs = torch.zeros(shape, dtype=self._cache_dtype)
                ks[:, 0, :n_kv] = k.to(self._cache_dtype)
                vs[:, 0, :n_kv] = v.to(self._cache_dtype)
                self._insert_prefill_kv(slot, bucket, blocks, ks, vs, n_kv)
            self._tables[slot, :] = self.num_blocks
            self._tables[slot, : len(blocks)] = blocks
            self._blocks_hw = max(self._blocks_hw, self._mgr.n_in_use)
            now = time.perf_counter()
            ms = (now - t0) * 1e3
            if req.preempted_t:
                req.preempt_overhead_s += now - req.preempted_t
                req.preempted_t = 0.0
            _telemetry.counter("serving.host_tier.resumes").inc()
            _telemetry.sketch("serving.host_tier.page_in_ms").observe(ms)
            if _telemetry.enabled():
                sample_device_memory()
            st = _Slot(request=req, tokens=list(req.resume_tokens),
                       prefill_ms=ms, blocks=blocks, cache_len=n_kv,
                       decode_polls=req.resume_polls)
        except Exception:
            self._mgr.free_all(blocks)
            self._tables[slot, :] = self.num_blocks
            raise
        self._slots[slot] = st
        self._pending[slot] = int(req.resume_tokens[-1])
        self._temps[slot] = req.temperature
        self._bind_slot_lane(req, slot)
        self._spec_history(slot, self._full_tokens(req), None)
        return []

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
                    np.asarray([req.temperature], np.float32),
                    self._mask_arg(req))
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
        self._spec_history(slot, tokens, tok)
        done = self._finish_reason(st, tok)
        if done:
            completed.append(self._complete(slot, done))
        return completed

    # -- chunked prefill ---------------------------------------------------

    def _claim_blocks_chunked(self, n: int, hashes: List[bytes]):
        """Block claim of a chunked admission: the leading shared chunks
        (:meth:`_chunk_share_plan`) map their published blocks (HBM) or
        allocate, publish and page in (host tier); every other block
        allocates fresh and publishes as its chunk lands
        (:meth:`_publish_chunk_blocks`).  Returns (blocks, shared,
        page_ins, lo), ``lo`` the chunk-aligned prefill start; raises on
        exhaustion with everything unwound."""
        lead = self._chunk_share_plan(n, hashes)
        blocks: List[int] = []
        page_ins: List[tuple] = []
        shared = 0
        try:
            for h in hashes[:lead]:
                blk = self._mgr.share_prefix(h)
                if blk is not None:
                    blocks.append(blk)
                    shared += 1
                    continue
                hit = (self._host.peek_block(h)
                       if self._host is not None else None)
                if hit is None:
                    # the plan saw it in a tier; nothing runs in between
                    raise RuntimeError("shared chunk digest vanished "
                                       "mid-claim")
                blk = self._mgr.alloc()
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                self._mgr.publish_prefix(h, blk)
                blocks.append(blk)
                page_ins.append((blk, hit))
            for _ in range(len(blocks), blocks_for(n, self.block_size)):
                blk = self._mgr.alloc()
                if blk is None:
                    raise RuntimeError("block pool exhausted mid-admit")
                blocks.append(blk)
        except Exception:
            self._mgr.free_all(blocks)
            raise
        return blocks, shared, page_ins, lead * self.block_size

    def _admit_one_chunked(self, req: Request, slot: int) -> List[Response]:
        """Admit a long prompt without running its prefill: claim the lane
        and (paged) every block the prompt needs, park the lane's position
        at the shared boundary, and mark it ``prefilling``; the chunks run
        one a step (:meth:`_prefill_chunk_once`)."""
        tokens = self._full_tokens(req)
        n = int(tokens.size)
        blocks: List[int] = []
        hashes: List[bytes] = []
        page_ins: List[tuple] = []
        shared = lo = 0
        if self._mgr is not None:
            _tok, hashes = self._admission_state(req)
            blocks, shared, page_ins, lo = self._claim_blocks_chunked(
                n, hashes)
        t0 = time.perf_counter()
        if req.admitted_t == 0.0:
            req.admitted_t = t0
            req.queue_wait_s = t0 - req.submitted_t
        try:
            if self._mgr is not None:
                self._tables[slot, :] = self.num_blocks
                self._tables[slot, : len(blocks)] = blocks
                self._blocks_hw = max(self._blocks_hw, self._mgr.n_in_use)
                self._page_in_blocks(slot, page_ins)
            # a stale position of the lane's last occupant must not outlive
            # the handover (the lane rides the decode batch masked)
            self.cache["pos"][slot] = lo
            chunks = -(-(n - lo) // self.chunk_tokens)
            _telemetry.event("serving.request.chunk_admit",
                             id=req.request_id, prompt_tokens=n,
                             chunks=chunks, shared_blocks=shared,
                             paged_in_blocks=len(page_ins))
        except Exception:
            if self._mgr is not None:
                self._mgr.free_all(blocks)
                self._tables[slot, :] = self.num_blocks
            raise
        self._slots[slot] = _Slot(
            request=req, tokens=[], prefill_ms=0.0, blocks=blocks,
            cache_len=lo, shared_blocks=shared,
            decode_polls=req.resume_polls, prefilling=True, chunks_done=0,
            chunks_total=chunks, prefill_tokens=tokens,
            digests=hashes if self._mgr is not None else None,
            published_upto=(lo // self.block_size
                            if self._mgr is not None else 0))
        self._pending[slot] = 0
        self._temps[slot] = 0.0
        self._bind_slot_lane(req, slot)
        return []

    def _prefill_chunk_once(self) -> List[Response]:
        """Run one prefill chunk for the oldest prefilling lane; on its
        final chunk the lane samples its first token from the chunk's
        last real token and joins the decode batch."""
        slots = [s for s in self._pool.active
                 if self._slots[s] is not None and self._slots[s].prefilling]
        if not slots:
            return []
        slot = min(slots, key=lambda s: self._slots[s].request.request_id)
        st = self._slots[slot]
        req = st.request
        tokens = st.prefill_tokens
        n = int(tokens.size)
        lo = st.cache_len
        hi = min(n, lo + self.chunk_tokens)
        # one chunk shape for the engine's life: a tail chunk pads, and its
        # padding writes land past the lane's length or drop
        chunk = pad_prompt(tokens[lo:hi], self.chunk_tokens)
        where = (torch.from_numpy(self._tables[slot].copy())
                 if self._mgr is not None
                 else torch.tensor([slot], dtype=torch.long))
        t0 = time.perf_counter()
        with span("serving.prefill_chunk"), \
                compile_label("serving.prefill_chunk"):
            logits = self._chunk_call(where, chunk, lo)
            self.cache["pos"][slot] = hi
            if hi >= n:
                first = self._sample(
                    logits[:, n - 1 - lo],
                    np.asarray([req.temperature], np.float32),
                    self._mask_arg(req))
                tok = int(first[0])                      # host sync
        now = time.perf_counter()
        st.prefill_ms += (now - t0) * 1e3
        st.cache_len = hi
        st.chunks_done += 1
        if self._mgr is not None and st.digests is not None:
            self._publish_chunk_blocks(st, hi)
        _telemetry.counter("serving.prefill_chunks").inc()
        if hi < n:
            return []
        if req.first_token_t == 0.0:
            req.first_token_t = now
            _telemetry.event("serving.request.first_token",
                             id=req.request_id, slo_class=req.slo_class)
        if req.preempted_t:
            req.preempt_overhead_s += now - req.preempted_t
            req.preempted_t = 0.0
        self._prefill_count += 1
        _telemetry.counter("serving.prefill_calls").inc()
        _telemetry.histogram("serving.prefill_ms").observe(st.prefill_ms)
        _telemetry.counter("serving.tokens_generated").inc()
        if _telemetry.enabled():
            sample_device_memory()
        st.prefilling = False
        st.prefill_tokens = None
        st.tokens = list(req.resume_tokens) + [tok]
        self._pending[slot] = tok
        self._temps[slot] = req.temperature
        self._spec_history(slot, tokens, tok)
        done = self._finish_reason(st, tok)
        if done:
            return [self._complete(slot, done)]
        return []

    def _publish_chunk_blocks(self, st: _Slot, hi: int) -> None:
        """Publish every newly full block's chunk-namespace digest once its
        chunk has written it; the first publisher wins (a digest already
        published keeps its block, and this lane's copy stays
        private)."""
        full = min(hi // self.block_size, len(st.digests))
        for b in range(st.published_upto, full):
            if self._mgr.lookup_prefix(st.digests[b]) is None:
                self._mgr.publish_prefix(st.digests[b], st.blocks[b])
        st.published_upto = max(st.published_upto, full)

    # -- decode ------------------------------------------------------------

    def _youngest_slot(self) -> int:
        """The preemption victim: the most recently submitted live
        request."""
        return max(self._pool.active,
                   key=lambda s: self._slots[s].request.request_id)

    def _host_park_digests(self, blocks: List[int]) -> None:
        """Cold-prefix eviction: park, under their chain digests, the
        published blocks of ``blocks`` this release would free (refcount
        1; blocks other tables still share stay in HBM), gathered in one
        call (an int8 pool dequantized: the page-in requantizes).  Raw
        wire only.  Runs before ``free_all``: it reads the refcounts and
        the pages."""
        if self._host is None or self._host.wire != "raw":
            return
        victims = []
        for blk in blocks:
            h = self._mgr.digest_of(blk)
            if (h is None or self._mgr.refcount(blk) != 1
                    or self._host.has_block(h)):
                continue
            victims.append((h, blk))
        if not victims:
            return
        ids = [blk for _h, blk in victims]
        k, v = gather_block_kv(self.cache["k"], self.cache["v"], ids)
        if "k_scale" in self.cache:
            k = dequantize_kv(k, gather_block_scales(self.cache["k_scale"],
                                                     ids))
            v = dequantize_kv(v, gather_block_scales(self.cache["v_scale"],
                                                     ids))
        k, v = k.cpu(), v.cpu()
        bs = self.block_size
        for i, (h, _blk) in enumerate(victims):
            self._host.put_block(h, k[:, i * bs:(i + 1) * bs],
                                 v[:, i * bs:(i + 1) * bs])

    def _host_park(self, slot: int, st: _Slot) -> None:
        """Page a preemption victim out before its blocks free: its dying
        published blocks by digest, and, for a decoding lane, its
        materialized tokens under (request, token count), so that its
        re-admission is a page-in.  A mid-prefill lane has no pending
        token to resume behind: it restarts its chunks, and the digests
        parked here page its finished chunks back in."""
        self._host_park_digests(st.blocks)
        if st.prefilling or st.cache_len < 1:
            return
        tables = torch.from_numpy(self._tables).to(self.device)
        k, v = extract_kv(dict(self.cache, block_tables=tables),
                          st.cache_len, row=slot)
        self._host.put_request(st.request.request_id, st.cache_len, k, v)

    def _preempt(self, slot: int) -> None:
        """Evict one live request: park its pages in the host tier when
        there is one, free its blocks (shared prefix blocks survive under
        their other owners), park its progress on the Request, requeue it
        at the front, release the lane."""
        st = self._slots[slot]
        if self._host is not None:
            self._host_park(slot, st)
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
        # an injected handoff dies with its blocks: resume pages the parked
        # copy back in or replays through the local prefill
        req.handoff = None
        req.handoff_shareable = False
        req.preemptions += 1
        req.resume_polls = st.decode_polls
        req.preempted_t = time.perf_counter()
        self._queue.appendleft(req)
        self._preempt_count += 1
        _telemetry.counter("serving.preemptions").inc()
        _telemetry.event("serving.request.preempt", id=req.request_id,
                         tokens=len(st.tokens), blocks_freed=len(st.blocks))

    def _ensure_tail_blocks(self) -> None:
        """Map blocks for every live lane's next write horizon now (one
        token, or the pending token plus k drafts under spec; writes past
        the table's reach drop); on pool exhaustion preempt the youngest
        live request, repeatedly, until the allocation succeeds or the
        needy lane itself was evicted."""
        mb = self._tables.shape[1]
        for slot in list(self._pool.active):
            st = self._slots[slot]
            if st is None or st.prefilling:     # preempted this pass, or
                continue                        # blocks claimed at admit
            need = min(-(-(st.cache_len + self._spec_ahead)
                         // self.block_size), mb)
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
        """One decode step over every lane (live ones advance; free and
        prefilling lanes ride along frozen): the ``decode`` entry (the
        step and the greedy tokens), then, when a live lane samples, the
        ``sample`` entry (kernel K4) over the same logits; one host sync
        reads the tokens.  Under ``spec`` the ``decode`` entry is one
        speculative round, and the host sync reads each lane's candidate
        emission and accepted count."""
        if self._mgr is not None:
            self._ensure_tail_blocks()
            if not self._pool.n_active:        # everything preempted
                return []
        active = np.asarray([st is not None and not st.prefilling
                             for st in self._slots])
        if not active.any():                   # only prefilling lanes
            return []
        t0 = time.perf_counter()
        with compile_label("serving.decode"):
            args = self._decode_args(torch.from_numpy(self._pending.copy()),
                                     torch.from_numpy(active))
            if self._spec is not None:
                out = self._cc("decode", _spec_entry, tuple(args),
                               self._spec_bound)
                out_host = out.cpu().numpy()             # host sync
                em_host, acc_host = out_host[:, :-1], out_host[:, -1]
            else:
                logits, nxt = self._cc("decode", _decode_entry, tuple(args),
                                       self._decode_bound)
                self.last_logits = logits
                if (self._temps > 0).any():
                    words = torch.tensor(_seed_words(self._gen),
                                         dtype=torch.int64)
                    nxt = self._cc("sample", _sample_entry,
                                   (logits,
                                    torch.from_numpy(self._temps.copy()),
                                    words), self._sample_bound)
                nxt_host = nxt.cpu().numpy()             # host sync
        dt = time.perf_counter() - t0
        _telemetry.counter("serving.decode_steps").inc()
        self._decode_count += 1
        if self._decode_count % 64 == 0 and _telemetry.enabled():
            sample_device_memory()
        completed = []
        emitted = accepted = live = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.prefilling:
                continue
            live += 1
            st.decode_polls += 1
            if self._spec is None:
                n_raw = 1
                toks = [int(nxt_host[slot])]
            else:
                n_raw = int(acc_host[slot]) + 1
                accepted += n_raw - 1
                toks = [int(t) for t in em_host[slot, :n_raw]]
            # the device committed n_raw entries; the host delivers them in
            # order up to EOS or the budget, and a lane that stops short
            # completes now (its cache_len drifts only on release)
            st.cache_len += n_raw
            done = None
            for tok in toks:
                st.tokens.append(tok)
                self._pending[slot] = tok
                emitted += 1
                done = self._finish_reason(st, tok)
                if done:
                    break
            if done:
                completed.append(self._complete(slot, done))
        _telemetry.counter("serving.tokens_generated").inc(emitted)
        if self._spec is not None and live:
            # verify_calls counts per-lane verify passes, as generate does
            _telemetry.counter("generate.spec.draft_tokens").inc(
                self._spec.k * live)
            _telemetry.counter("generate.spec.accepted_tokens").inc(accepted)
            _telemetry.counter("generate.spec.verify_calls").inc(live)
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
            # completion is the other cold-prefix eviction edge
            self._host_park_digests(st.blocks)
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
        reg = _telemetry.registry()
        if reg is not None and reg.detectors is not None:
            reg.detectors.feed_slo(req.slo_class, met)
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


# -- the ladder's entry functions: tensors in, tensors out, no host sync --


def _prefill_entry(padded, lens, *, params, cfg, bucket, cache_dtype,
                   backend):
    """``prefill[bucket]``: one padded prompt ``[1, bucket]`` → (its
    last-token logits ``[1, v]``, the bucket cache's K and V)."""
    logits, small = prefill(params, padded, cfg, prompt_lens=lens,
                            max_len=bucket, cache_dtype=cache_dtype,
                            device=padded.device, backend=backend)
    return logits, small["k"], small["v"]


def _insert_entry(ks, vs, where, n, *, cache, layout, bucket, block_size):
    """``insert[bucket]``: a bucket cache into the pool through the write
    ids ``where`` (paged; length ``n``) or into stripe ``where`` [1]
    (contiguous)."""
    if layout == "paged":
        if "k_scale" in cache:
            paged_insert_prefill_q(cache["k"], cache["v"], cache["k_scale"],
                                   cache["v_scale"], ks, vs, where, n,
                                   block_size=block_size)
        else:
            paged_insert_prefill(cache["k"], cache["v"], ks, vs, where, n,
                                 block_size=block_size)
        return
    cache["k"][:, where, :bucket] = ks.to(cache["k"].dtype)
    cache["v"][:, where, :bucket] = vs.to(cache["v"].dtype)


def _decode_entry(tokens, active, *lane_args, params, cache, cfg, paged,
                  slabs, masks, vocab_limit, backend):
    """``decode``: one step over every lane → (logits ``[slots, v]``, the
    greedy tokens).  ``lane_args``: the block tables (paged), then the
    LoRA lane ids (with a pool).  Inactive lanes keep their position (an
    in-place update: the graph reads and writes the same ``pos``)."""
    lane_args = list(lane_args)
    full = dict(cache)
    if paged:
        full["block_tables"] = lane_args.pop(0)
    lora = None if slabs is None else {"idx": lane_args.pop(0),
                                       "slabs": slabs}
    prev = cache["pos"]
    logits, new = decode_step(params, tokens, full, cfg, lora=lora,
                              device=tokens.device, backend=backend)
    cache["pos"].copy_(torch.where(active, new["pos"], prev))
    greedy = fused_sample(logits, temperature=0.0, vocab_limit=vocab_limit,
                          token_mask=masks, backend=backend)
    return logits, greedy


def _spec_entry(tokens, active, temps, words, *lane_args, params, cache, cfg,
                spec, history, hist_len, paged, slabs, masks, top_k, top_p,
                vocab_limit, backend):
    """``decode`` under ``spec``: one speculative round over every lane →
    ``[slots, k+2]`` int32, each lane's candidate emission ``[k+1]`` then
    its accepted count.  Live lanes commit ``pos += n_acc + 1`` and append
    those tokens to their history, in place; inactive lanes keep both (a
    free lane's verify writes drop through its sentinel table row).  No
    host read: a CUDA graph captures the round, and a replay reads the
    key words copied into ``words``."""
    lane_args = list(lane_args)
    full = dict(cache)
    if paged:
        full["block_tables"] = lane_args.pop(0)
    lora = None if slabs is None else {"idx": lane_args.pop(0),
                                       "slabs": slabs}
    max_len = history.shape[1] - 1
    prev = cache["pos"]
    em, n_acc, _y, _new, _prev = spec_round(
        params, cfg, full, tokens, history[:, :max_len], hist_len, words,
        spec=spec, temperature=temps, top_k=top_k, top_p=top_p,
        vocab_limit=vocab_limit, token_mask=masks, lora=lora,
        backend=backend)
    n_raw = n_acc + 1
    cache["pos"].copy_(torch.where(active, prev + n_raw, prev))
    # the delivered tokens at each live lane's length; the others and
    # the cells past max_len land in the scratch column
    col = torch.arange(em.shape[1], device=em.device)[None]
    keep = (col < n_raw[:, None]) & active[:, None]
    cols = torch.where(keep, hist_len[:, None].long() + col, max_len)
    history.scatter_(1, cols.clamp(max=max_len), em)
    hist_len.copy_(torch.where(active, (hist_len + n_raw).clamp(max=max_len),
                               hist_len))
    return torch.cat([em, n_acc[:, None]], dim=1)


def _sample_entry(logits, temps, words, *, masks, top_k, top_p,
                  vocab_limit, backend):
    """``sample``: kernel K4 over the decode batch, keyed by the two words
    in ``words`` (read in place, so a replay draws anew)."""
    return fused_sample(logits, seed_words=words, temperature=temps,
                        top_k=top_k, top_p=top_p, vocab_limit=vocab_limit,
                        token_mask=masks, backend=backend)


def _chunk_entry(chunk, where, lo, *, params, cache, cfg, paged, backend):
    """``chunk``: ``chunk_tokens`` tokens of one lane appended at ``lo``
    through :func:`decode_verify` → logits ``[1, chunk_tokens, v]``.  The
    lane is named by its table row (paged) or its slot (contiguous: the
    stripes read as a pool of one ``max_len`` block a lane, so a slot
    number held in device memory selects it)."""
    sub = dict(cache)
    sub["block_tables"] = where[None] if paged else where.view(1, 1)
    sub["pos"] = lo
    logits, _ = decode_verify(params, chunk[None], sub, cfg,
                              device=chunk.device, backend=backend)
    return logits
