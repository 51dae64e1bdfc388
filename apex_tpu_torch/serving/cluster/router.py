"""SLO-aware router over disaggregated prefill/decode worker pools
(``apex_tpu/serving/cluster/router.py``).

A request arrives with an SLO class; the router

1. **admits** it against a per-class queue-depth cap (an overloaded
   fleet sheds *batch* load first; the cap returns :class:`RouterBusy`
   to the caller instead of queueing without bound);
2. **dispatches** by class priority (``class_priority`` — interactive
   ahead of standard ahead of batch): one RPC to a prefill worker
   produces the first token + the serialized KV handoff, which is
   forwarded — blobs untouched, the router never deserializes a cache —
   to the decode worker that holds the request's adapter or prefix, else
   the one with the most headroom in tokens, where it is injected and
   continuously batched;
3. **collects** completions by polling decode workers (the poll reply
   piggybacks ``engine.stats()``, the live admission signal);
4. **degrades loudly**: RPC failures feed the
   :class:`~apex_tpu_torch.observability.detectors.PoolStallDetector`,
   so a stalled pool latches ``/healthz`` to 503 when the router process
   exports telemetry; a dead decode worker's in-flight requests REQUEUE
   at the front of their class queue (re-prefilled and re-dispatched to
   a surviving worker — requests are never lost).

Telemetry (``cluster.*``, no-op unless configured): ``cluster.route``
(counter, per pool × class), ``cluster.handoff_bytes`` (counter),
``cluster.pool_occupancy{pool=}`` / ``cluster.queue_depth{slo_class=}``
/ ``cluster.inflight`` (gauges), ``cluster.rebalance`` /
``cluster.requeued`` / ``cluster.rejected`` (counters), and
``cluster.scale_hint{pool=}`` from :meth:`Router.autoscale_signal`,
which fuses the live scrapes with a windowed fleet summary.

The router holds no device, model or torch state: prompts are integer
lists, KV handoffs are opaque blobs forwarded verbatim, deadlines come
from :mod:`apex_tpu_torch.serving.slo` (pure Python).  Its wire is the
JAX package's, so it routes over either package's workers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import socket
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.serving.cluster import protocol
from apex_tpu_torch.serving.slo import judge as _judge_slo
from apex_tpu_torch.serving.slo import resolve_slo_targets
from apex_tpu_torch.serving.slo import tpot_ms as _tpot_ms

__all__ = ["Router", "RouterBusy", "ClusterResponse",
           "DEFAULT_CLASS_PRIORITY"]

# dispatch order: latency-sensitive classes first.  Unknown classes
# slot in just before "batch" (they at least beat the explicitly
# latency-insensitive tier).
DEFAULT_CLASS_PRIORITY = ("interactive", "standard", "default", "batch")


class RouterBusy(RuntimeError):
    """Admission refused: the request's SLO class is at its queue cap."""


class WorkerDied(RuntimeError):
    """An RPC against a worker failed; the worker is marked dead."""


@dataclasses.dataclass
class ClusterResponse:
    """One completed request as the ROUTER measured it: latency stamps
    span submit → handoff → remote decode → poll receipt, so TTFT/e2e
    include every wire hop (the honest disaggregation cost).  Field
    names match the engine's :class:`~apex_tpu_torch.serving.Response`
    where they mean the same thing, so one per-class summary serves both
    topologies."""

    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray
    finish_reason: str
    slo_class: str = "default"
    queue_wait_ms: float = 0.0     # submit -> dispatch start
    ttft_ms: float = 0.0           # submit -> first token at router
    tpot_ms: float = 0.0
    e2e_ms: float = 0.0            # submit -> completion at router
    prefill_ms: float = 0.0        # remote prefill forward
    decode_steps: int = 0
    preemptions: int = 0
    requeues: int = 0              # decode-worker deaths survived
    migrations: int = 0            # scale-down drains survived
    handoff_bytes: int = 0
    pool: str = ""                 # decode worker that finished it
    slo_met: bool = True


@dataclasses.dataclass
class _Pending:
    """Router-side state of one live request."""

    rid: int
    prompt: np.ndarray
    kwargs: dict
    slo_class: str
    submitted_t: float
    dispatch_t: float = 0.0
    first_token_t: float = 0.0
    prefill_ms: float = 0.0
    handoff_bytes: int = 0
    requeues: int = 0
    # tokens already generated before a scale-down migration moved the
    # request to a survivor: the survivor's response carries
    # only its own half, and _finalize stitches prior + survivor back
    # into the full sequence.  Reset whenever the request goes back
    # through a fresh prefill dispatch (which regenerates everything).
    prior_tokens: List[int] = dataclasses.field(default_factory=list)
    migrations: int = 0
    # source-leg accounting carried across migrations (the survivor's
    # response covers only its own leg)
    prior_preemptions: int = 0
    prior_decode_steps: int = 0
    # (block_size, chunk_tokens) -> hex16 chain digests of the prompt
    #: memoized so prefix-affinity scoring hashes each
    # prompt once per pool geometry, not once per candidate worker
    digest_memo: Dict[tuple, List[str]] = dataclasses.field(
        default_factory=dict)


def _prompt_digests(prompt, block_size: int,
                    chunk_tokens: int) -> List[str]:
    """hex16 chained digests of every full block of ``prompt``, in the
    namespace the worker would PUBLISH them under — the
    chunk salt when the worker would chunk this prompt, the flash salt
    otherwise.  A router-side mirror of
    :func:`apex_tpu_torch.serving.paged_cache.prefix_block_hashes`
    (chained SHA-256 over int64 token bytes) kept free of the serving
    stack by the module docstring's data-path contract — the router never imports the
    serving stack to score a dispatch."""
    tokens = np.asarray(prompt, np.int64).reshape(-1)
    n = int(tokens.size)
    h = (b"chunk:%d" % chunk_tokens
         if chunk_tokens and n > chunk_tokens else b"")
    out: List[str] = []
    for i in range(n // block_size):
        blk = tokens[i * block_size: (i + 1) * block_size]
        h = hashlib.sha256(h + blk.tobytes()).digest()
        out.append(h.hex()[:16])
    return out


def _headroom_tokens(stats: dict) -> float:
    """Free capacity of one worker in TOKENS ADMITTABLE (block counts lie across block sizes, bytes lie across
    ``cache_wire`` forms — an int8 pool holds ~1.88x the blocks at
    matched bytes).  Tokens are the one unit every pool form shares.
    Older workers without the key fall back to blocks x the worker's
    allocation unit (a block on paged workers, a whole ``max_len``
    stripe on contiguous ones) — consistent ordering within a
    homogeneous pool.  Dispatch ordering (``_pick_decode``) and the
    autoscale hint MUST share this conversion or they disagree about
    the same worker's capacity."""
    unit = stats.get("block_size") or stats.get("max_len", 1)
    return stats.get("headroom_tokens",
                     stats.get("free_block_headroom", 0) * unit)


class _Worker:
    """Client half of one worker connection (blocking RPC with a
    timeout; any failure marks the worker dead — the router routes
    around it and the pool detector decides when that's an incident)."""

    def __init__(self, addr: str, pool: str, timeout: float):
        self.addr = addr
        self.pool = pool
        self.timeout = timeout
        # router state is confined to the dispatch thread (the router
        # is stepped, never shared)
        self.alive = True                        # guarded-by: confined(router-thread)
        # draining: the elastic controller marked this
        # worker for scale-down — no NEW work lands on it while its
        # in-flight state migrates to survivors
        self.draining = False                    # guarded-by: confined(router-thread)
        self.stats: dict = {}                    # guarded-by: confined(router-thread)
        self.in_flight: Dict[int, _Pending] = {}  # guarded-by: confined(router-thread)
        # dispatches since the last stats refresh: the stats snapshot
        # goes stale inside one dispatch burst, and without this the
        # whole burst would land on whichever worker looked best at
        # the last poll
        self.dispatched_since_poll = 0
        host, _, port = addr.rpartition(":")
        self._sock = socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=timeout)
        self._sock.settimeout(timeout)

    def rpc(self, header: dict, blobs: Sequence[bytes] = ()
            ) -> Tuple[dict, List[bytes]]:
        if not self.alive:
            raise WorkerDied(f"{self.pool} worker {self.addr} is dead")
        try:
            protocol.send_msg(self._sock, header, blobs)
            msg = protocol.recv_msg(self._sock)
        except (OSError, protocol.ProtocolError) as e:
            self.kill()
            raise WorkerDied(
                f"{self.pool} worker {self.addr}: {e}") from e
        if msg is None:
            self.kill()
            raise WorkerDied(
                f"{self.pool} worker {self.addr} closed the connection")
        reply, rblobs = msg
        if not reply.get("ok"):
            # an application-level refusal is an error, not a death —
            # the worker answered coherently
            raise RuntimeError(
                f"{self.pool} worker {self.addr}: "
                f"{reply.get('error', 'rejected')}")
        return reply, rblobs

    def kill(self) -> None:
        self.alive = False
        try:
            self._sock.close()
        except OSError:
            pass


class Router:
    """SLO-aware dispatch over prefill/decode pools (see module doc).

    ``prefill`` / ``decode`` are worker addresses (``host:port``).
    ``queue_caps`` maps SLO class → max queued at the router (absent =
    uncapped); ``class_priority`` orders dispatch.  ``wire_dtype`` is
    the KV handoff format the prefill pool is asked for (``"raw"`` =
    bit-exact, the token-identity default; ``"bf16"``/``"int8"``
    compress the wire at a parity cost — see
    ``serving/cluster/handoff.py``).

    Drive it like the engine: :meth:`submit` + :meth:`step` in a loop
    (or :meth:`run` / :meth:`run_trace`), collect
    :class:`ClusterResponse` from each step's return."""

    def __init__(self, prefill: Sequence[str], decode: Sequence[str], *,
                 slo_targets: Optional[dict] = None,
                 queue_caps: Optional[Dict[str, int]] = None,
                 class_priority: Sequence[str] = DEFAULT_CLASS_PRIORITY,
                 wire_dtype: str = "raw",
                 max_worker_queue: int = 4,
                 rpc_timeout: float = 60.0):
        if not prefill or not decode:
            raise ValueError("need at least one prefill and one decode "
                             "worker address")
        self._rpc_timeout = float(rpc_timeout)
        self._prefill = [_Worker(a, "prefill", rpc_timeout)
                         for a in prefill]
        self._decode = [_Worker(a, "decode", rpc_timeout)
                        for a in decode]
        for w in self._prefill + self._decode:
            reply, _ = w.rpc({"op": "hello"})
            if reply.get("role") != w.pool:
                w.kill()
                raise ValueError(
                    f"{w.addr} answered role={reply.get('role')!r}, "
                    f"expected {w.pool!r} — check the pool wiring")
        self._slo_targets = resolve_slo_targets(slo_targets)
        self._caps = dict(queue_caps or {})
        self._priority = tuple(class_priority)
        self.wire_dtype = wire_dtype
        self._max_worker_queue = int(max_worker_queue)
        self._queues: Dict[str, deque] = {}      # guarded-by: confined(router-thread)
        self._next_rid = 0                       # guarded-by: confined(router-thread)
        self._pf_rr = 0                      # prefill round-robin cursor
        self._last_decode_pick: Optional[str] = None
        self._requeued_total = 0
        self._completed_total = 0
        # responses banked by drain_worker (completed-but-unpolled at
        # the drained worker), collected via take_drain_completions
        self._drain_completed: List[ClusterResponse] = []   # guarded-by: confined(router-thread)

    # -- admission ----------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               slo_class: str = "default",
               adapter_id: int = 0) -> int:
        """Admit one request → rid, or raise :class:`RouterBusy` when
        the class's router queue is at its cap (shed load explicitly;
        the caller decides whether to retry, downgrade the class, or
        surface a 429)."""
        slo_class = str(slo_class)
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError("adapter_id must be >= 0")
        q = self._queues.setdefault(slo_class, deque())
        cap = self._caps.get(slo_class)
        if cap is not None and len(q) >= cap:
            _telemetry.counter("cluster.rejected",
                               {"slo_class": slo_class}).inc()
            raise RouterBusy(
                f"class {slo_class!r} queue is at its cap ({cap}); "
                "shedding load")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        rid = self._next_rid
        self._next_rid += 1
        pend = _Pending(
            rid=rid, prompt=prompt,
            kwargs=dict(max_new_tokens=int(max_new_tokens),
                        temperature=float(temperature),
                        eos_token_id=eos_token_id,
                        adapter_id=adapter_id),
            slo_class=slo_class, submitted_t=time.perf_counter())
        q.append(pend)
        self._set_gauges()
        return rid

    # -- the dispatch/collect cycle ----------------------------------------

    def step(self) -> List[ClusterResponse]:
        """One router cycle: collect completions from every decode
        worker — responses a scale-down drain banked included, so a
        plain submit+step caller never loses a drain-time finish —
        then dispatch as much queued work as the pools have appetite
        for.  Returns the requests completed this cycle."""
        completed = self._poll_decode()
        completed.extend(self.take_drain_completions())
        self._dispatch()
        self._set_gauges()
        return completed

    def run(self, max_wall_s: float = 300.0, poll_s: float = 0.005,
            on_step=None) -> List[ClusterResponse]:
        """Drive :meth:`step` until every queued/in-flight request
        completed (or the wall budget runs out — whatever is still
        pending stays pending, visible in :meth:`stats`).  ``on_step``
        (no-arg callable) runs every cycle on THIS thread — the
        elastic controller's ``maybe_tick`` rides here so its state
        stays inside the router's single-thread confinement."""
        out: List[ClusterResponse] = []
        deadline = time.time() + max_wall_s
        while self.pending and time.time() < deadline:
            got = self.step()
            out.extend(got)
            if on_step is not None:
                on_step()
                out.extend(self.take_drain_completions())
            if not got and self.pending:
                if not any(w.alive for w in self._decode):
                    raise RuntimeError(
                        f"all decode workers dead with {self.pending} "
                        "requests pending — nothing left to requeue "
                        "onto")
                time.sleep(poll_s)
        return out

    def run_trace(self, trace: Sequence[Tuple[float, dict]],
                  max_wall_s: float = 300.0,
                  on_step=None) -> List[ClusterResponse]:
        """Open-loop replay: submit each ``(t_offset_s, submit_kwargs)``
        at its offset from now — arrivals do NOT wait for completions
        (the load a real fleet sees) — stepping continuously; then
        drain.  Requests a cap rejects are dropped from the replay (the
        shed-load outcome) and counted in ``cluster.rejected``.
        ``on_step`` as in :meth:`run` (the controller hook)."""
        t0 = time.perf_counter()
        order = sorted(trace, key=lambda item: item[0])
        i = 0
        out: List[ClusterResponse] = []
        while i < len(order) or self.pending:
            now = time.perf_counter() - t0
            while i < len(order) and order[i][0] <= now:
                try:
                    self.submit(**order[i][1])
                except RouterBusy:
                    pass
                i += 1
            got = self.step()
            out.extend(got)
            if on_step is not None:
                on_step()
                out.extend(self.take_drain_completions())
            if i < len(order):
                wait = min(order[i][0] - (time.perf_counter() - t0),
                           0.002)
                if wait > 0:
                    time.sleep(wait)
            elif not got and self.pending:
                # drain phase: pace the poll loop instead of hammering
                # the workers' control plane between completions
                time.sleep(0.002)
            if time.perf_counter() - t0 > max_wall_s:
                break
        return out

    @property
    def pending(self) -> int:
        """Requests queued at the router or in flight on a pool."""
        queued = sum(len(q) for q in self._queues.values())
        inflight = sum(len(w.in_flight) for w in self._decode)
        return queued + inflight

    # -- internals ----------------------------------------------------------

    def _feed_pool(self, pool: str, ok: bool,
                   detail: Optional[str] = None) -> None:
        reg = _telemetry.registry()
        if reg is not None and reg.detectors is not None:
            reg.detectors.feed_pool(pool, ok, detail)

    def _set_gauges(self) -> None:
        for cls, q in self._queues.items():
            _telemetry.gauge("cluster.queue_depth",
                             {"slo_class": cls}).set(len(q))
        _telemetry.gauge("cluster.inflight").set(
            sum(len(w.in_flight) for w in self._decode))
        for w in self._decode:
            if w.alive and w.stats.get("max_slots"):
                _telemetry.gauge("cluster.pool_occupancy",
                                 {"pool": w.addr}).set(
                    w.stats.get("active", 0) / w.stats["max_slots"])

    def _next_class(self) -> Optional[str]:
        """Highest-priority class with queued work; classes not in the
        priority list rank just above 'batch'."""
        ranked = sorted(
            (cls for cls, q in self._queues.items() if q),
            key=lambda cls: (self._priority.index(cls)
                             if cls in self._priority
                             else len(self._priority) - 1.5))
        return ranked[0] if ranked else None

    def _pick_prefill(self) -> Optional[_Worker]:
        alive = [w for w in self._prefill
                 if w.alive and not w.draining]
        if not alive:
            return None
        w = alive[self._pf_rr % len(alive)]
        self._pf_rr += 1
        return w

    @staticmethod
    def _affinity(pend: _Pending, w: _Worker) -> int:
        """Prefix-cache affinity of one request against one worker's
        digest inventory: the deepest chain digest of the
        prompt that the worker reports resident, in blocks, weighted
        by tier — x2 for HBM (a hit is a zero-copy ``share_prefix``)
        vs x1 for host (a hit still pays the page-in scatter).  A
        chain digest at depth ``i`` proves blocks ``0..i`` all match,
        so depth alone is the score — no per-block set intersection.
        Workers that predate the inventory (or contiguous layouts)
        score 0 and fall through to pure headroom ordering."""
        inv = w.stats.get("digest_inventory")
        if not inv:
            return 0
        bs = int(inv.get("block_size") or 0)
        if bs < 1:
            return 0
        key = (bs, int(inv.get("chunk_tokens") or 0))
        chain = pend.digest_memo.get(key)
        if chain is None:
            chain = _prompt_digests(pend.prompt, key[0], key[1])
            pend.digest_memo[key] = chain
        score = 0
        for tier, weight in (("hbm", 2), ("host", 1)):
            heads = inv.get(tier)
            if not heads:
                continue
            heads = set(heads)
            for i in range(len(chain) - 1, -1, -1):
                if chain[i] in heads:
                    score = max(score, (i + 1) * weight)
                    break
        return score

    @staticmethod
    def _adapter_affinity(pend: _Pending, w: _Worker) -> int:
        """Adapter-residency affinity: 1 when the worker's
        adapter pool reports the request's LoRA adapter resident (the
        slab is already in HBM — dispatch skips a slab upload and a
        possible eviction), else 0.  Base requests (adapter_id 0) and
        workers that predate the inventory score 0 and fall through to
        prefix affinity / headroom ordering."""
        aid = pend.kwargs.get("adapter_id", 0)
        if not aid:
            return 0
        inv = w.stats.get("adapter_pool") or {}
        return 1 if aid in (inv.get("resident_ids") or ()) else 0

    def _pick_decode(self, pend: Optional[_Pending] = None
                     ) -> Optional[_Worker]:
        """The decode worker already holding the request's prefix
        (longest digest-prefix match x tier weight), then by
        most free-block headroom below the router's per-worker queue
        cap — the admission signals :meth:`ServingEngine.stats`
        exports for exactly this choice.  Affinity ranks BEFORE
        headroom: landing repeat-prefix traffic on the worker holding
        the pages converts its prefill into a ``share_prefix`` (or a
        host page-in), which COSTS less headroom than a fresh prefill
        anywhere else would.  ``None`` = every worker is saturated
        (backpressure: the request stays queued at the ROUTER, where
        class priority still applies — parking it on a worker's FIFO
        would forfeit the interactive-ahead-of-batch property)."""
        best, best_key = None, None
        for w in self._decode:
            if not w.alive or w.draining:
                continue
            backlog = (w.stats.get("queued", 0)
                       + w.dispatched_since_poll)
            if backlog >= self._max_worker_queue:
                continue
            # headroom in TOKENS ADMITTABLE:
            # block counts lie across heterogeneous block sizes and
            # bytes lie across cache_wire forms (an int8 pool holds
            # ~1.88x the blocks at matched bytes) — tokens are the one
            # unit every pool form shares.  The dispatch correction
            # estimates one allocation unit per dispatch-since-poll —
            # a block on paged workers, a whole max_len stripe on
            # contiguous ones (slot admission reserves the stripe) —
            # matching the historical per-unit arithmetic in both
            # layouts.  Older workers without the key fall back to
            # block units (consistent ordering within a homogeneous
            # pool).
            unit = (w.stats.get("block_size")
                    or w.stats.get("max_len", 1))
            # adapter affinity outranks prefix affinity: a slab miss
            # stalls ADMISSION (upload + possible eviction churn) while
            # a prefix miss only costs a redundant prefill
            key = (self._adapter_affinity(pend, w)
                   if pend is not None else 0,
                   self._affinity(pend, w) if pend is not None else 0,
                   _headroom_tokens(w.stats)
                   - w.dispatched_since_poll * unit,
                   -backlog)
            if best_key is None or key > best_key:
                best, best_key = w, key
        if best is not None and best_key[0] > 0:
            _telemetry.counter("cluster.adapter_affinity_hits").inc()
        if best is not None and best_key[1] > 0:
            _telemetry.counter("cluster.prefix_affinity_hits").inc()
        return best

    def _dispatch(self) -> None:
        while True:
            cls = self._next_class()
            if cls is None:
                return
            # peek the head request BEFORE picking the decode target:
            # the pick is prefix-affinity-aware, so it needs
            # the prompt it is placing
            pend = self._queues[cls][0]
            target = self._pick_decode(pend)
            if target is None:
                # work is queued and nowhere to put it.  Saturated
                # workers are backpressure (healthy); ZERO live
                # workers is a pool stall — feed the detector every
                # cycle so consecutive stalled cycles latch /healthz
                if not any(w.alive for w in self._decode):
                    self._feed_pool("decode", False,
                                    "no live decode workers")
                return
            pf = self._pick_prefill()
            if pf is None:
                self._feed_pool("prefill", False,
                                "no live prefill workers")
                return
            self._queues[cls].popleft()
            if pend.dispatch_t == 0.0:
                pend.dispatch_t = time.perf_counter()
            try:
                reply, blobs = pf.rpc({
                    "op": "prefill",
                    "prompt": [int(t) for t in pend.prompt],
                    "temperature": pend.kwargs["temperature"],
                    "adapter_id": pend.kwargs.get("adapter_id", 0),
                    "wire_dtype": self.wire_dtype,
                })
            except WorkerDied as e:
                self._feed_pool("prefill", False, str(e))
                self._queues[cls].appendleft(pend)
                if not any(w.alive for w in self._prefill):
                    return
                continue                    # retry on the next worker
            except RuntimeError as e:
                if "draining" in str(e):
                    # an externally drain-flagged prefill worker:
                    # adopt the flag and retry on the next member
                    pf.draining = True
                    self._queues[cls].appendleft(pend)
                    continue
                # any other application-level refusal is deterministic
                # — requeueing would loop forever.  Fail the request
                # loudly instead of wedging the class queue.
                _telemetry.counter("cluster.failed",
                                   {"slo_class": cls}).inc()
                _telemetry.event("cluster.request.failed",
                                 rid=pend.rid, error=str(e)[:200])
                continue
            self._feed_pool("prefill", True)
            # the first token exists NOW — TTFT ends here, before the
            # decode pool ever sees the request
            if pend.first_token_t == 0.0:
                pend.first_token_t = time.perf_counter()
            pend.prefill_ms = float(reply.get("prefill_ms", 0.0))
            pend.handoff_bytes = int(reply.get("handoff_bytes", 0))
            try:
                target.rpc({
                    "op": "decode",
                    "rid": pend.rid,
                    "prompt": [int(t) for t in pend.prompt],
                    "first_token": int(reply["first_token"]),
                    "prefill_ms": pend.prefill_ms,
                    "prefill_pages": bool(reply.get("prefill_pages")),
                    "kv": reply["kv"],
                    "slo_class": pend.slo_class,
                    **pend.kwargs,
                }, blobs)
            except WorkerDied as e:
                self._feed_pool("decode", False, str(e))
                self._requeue_pending(pend)
                if not any(w.alive for w in self._decode):
                    return
                continue
            except RuntimeError as e:
                if "draining" in str(e):
                    # the worker told us it is draining before our own
                    # flag landed (another router, an external drain):
                    # adopt the flag so _pick_decode routes around it
                    # and requeue — a drain refusal is backpressure,
                    # never a lost request
                    target.draining = True
                    self._queues[cls].appendleft(pend)
                    continue
                _telemetry.counter("cluster.failed",
                                   {"slo_class": cls}).inc()
                _telemetry.event("cluster.request.failed",
                                 rid=pend.rid, error=str(e)[:200])
                continue
            self._feed_pool("decode", True)
            # a fresh prefill dispatch regenerates the whole sequence:
            # any migration-carried prefix would now double-count
            pend.prior_tokens = []
            target.in_flight[pend.rid] = pend
            target.dispatched_since_poll += 1
            if (self._last_decode_pick is not None
                    and target.addr != self._last_decode_pick):
                # the headroom ordering moved us off the previously
                # preferred worker — the load-balancing edge the
                # rebalance counter measures
                _telemetry.counter("cluster.rebalance").inc()
            self._last_decode_pick = target.addr
            _telemetry.counter(
                "cluster.route",
                {"pool": target.addr, "slo_class": cls}).inc()
            _telemetry.counter("cluster.handoff_bytes").inc(
                pend.handoff_bytes)

    def _poll_decode(self) -> List[ClusterResponse]:
        completed: List[ClusterResponse] = []
        for w in self._decode:
            if not w.alive:
                # a death can be observed anywhere (a dispatch RPC,
                # scrape_stats, a previous poll) — whoever saw it only
                # marked the worker dead.  The sweep here is the ONE
                # place that guarantees every dead worker's in-flight
                # requests requeue, whatever path killed it.
                if w.in_flight:
                    self._requeue_worker(w)
                continue
            try:
                reply, _ = w.rpc({"op": "poll"})
            except WorkerDied as e:
                self._feed_pool("decode", False, str(e))
                self._requeue_worker(w)
                continue
            self._feed_pool("decode", True)
            w.stats = reply.get("stats", {})
            w.dispatched_since_poll = 0
            for rec in reply.get("responses", []):
                pend = w.in_flight.pop(rec["rid"], None)
                if pend is None:
                    continue                # a requeued duplicate
                completed.append(self._finalize(pend, rec, w))
        self._completed_total += len(completed)
        return completed

    def _requeue_pending(self, pend: _Pending) -> None:
        """Put one in-flight request back at the FRONT of its class
        queue for a fresh prefill→decode dispatch (worker death, or a
        drain record that could not migrate).  The fresh dispatch
        regenerates the whole sequence, so any migration-carried
        prefix is dropped here."""
        pend.prior_tokens = []
        pend.prior_preemptions = 0
        pend.prior_decode_steps = 0
        pend.requeues += 1
        self._requeued_total += 1
        _telemetry.counter("cluster.requeued").inc()
        self._queues.setdefault(pend.slo_class,
                                deque()).appendleft(pend)

    def _requeue_worker(self, w: _Worker) -> None:
        """A decode worker died: everything in flight on it goes BACK
        to the front of its class queue (re-prefill + re-dispatch —
        requests are never lost)."""
        for rid, pend in sorted(w.in_flight.items(), reverse=True):
            self._requeue_pending(pend)
        w.in_flight.clear()

    def _finalize(self, pend: _Pending, rec: dict,
                  w: _Worker) -> ClusterResponse:
        now = time.perf_counter()
        tokens = np.asarray(rec.get("tokens", []), np.int32)
        if pend.prior_tokens:
            # scale-down migration: the survivor generated
            # only the post-migration half — stitch the full sequence
            tokens = np.concatenate([
                np.asarray(pend.prior_tokens, np.int32), tokens])
        e2e_ms = (now - pend.submitted_t) * 1e3
        ttft_ms = ((pend.first_token_t or now)
                   - pend.submitted_t) * 1e3
        tpot = _tpot_ms(pend.first_token_t or now, now, tokens.size)
        met = _judge_slo(self._slo_targets.get(pend.slo_class),
                         ttft_ms, tpot)
        reg = _telemetry.registry()
        if reg is not None and reg.detectors is not None:
            reg.detectors.feed_slo(pend.slo_class, met)
        tags = {"slo_class": pend.slo_class}
        _telemetry.sketch("cluster.ttft_ms", tags).observe(ttft_ms)
        _telemetry.sketch("cluster.e2e_ms", tags).observe(e2e_ms)
        _telemetry.counter(
            "cluster.goodput.met" if met else "cluster.goodput.missed",
            tags).inc()
        return ClusterResponse(
            request_id=pend.rid,
            prompt=pend.prompt,
            tokens=tokens,
            finish_reason=rec.get("finish_reason", "?"),
            slo_class=pend.slo_class,
            queue_wait_ms=((pend.dispatch_t or now)
                           - pend.submitted_t) * 1e3,
            ttft_ms=ttft_ms,
            tpot_ms=tpot or 0.0,
            e2e_ms=e2e_ms,
            prefill_ms=pend.prefill_ms,
            decode_steps=(pend.prior_decode_steps
                          + int(rec.get("decode_steps", 0))),
            preemptions=(pend.prior_preemptions
                         + int(rec.get("preemptions", 0))),
            requeues=pend.requeues,
            migrations=pend.migrations,
            handoff_bytes=pend.handoff_bytes,
            pool=w.addr,
            slo_met=met,
        )

    # -- elastic pool management ---------------------------------

    def _pool_list(self, pool: str) -> List[_Worker]:
        if pool not in ("prefill", "decode"):
            raise ValueError(
                f"pool={pool!r}: expected 'prefill' or 'decode'")
        return self._prefill if pool == "prefill" else self._decode

    def _find_worker(self, addr: str) -> _Worker:
        for w in self._prefill + self._decode:
            if w.addr == addr:
                return w
        raise ValueError(f"no worker at {addr!r}")

    def add_worker(self, addr: str, pool: str) -> None:
        """Attach a new pool member at runtime — the elastic
        controller's scale-up edge.  Same hello handshake as
        construction (a mis-wired role is refused loudly); the worker
        becomes dispatchable on the next cycle."""
        workers = self._pool_list(pool)
        w = _Worker(addr, pool, self._rpc_timeout)
        reply, _ = w.rpc({"op": "hello"})
        if reply.get("role") != pool:
            w.kill()
            raise ValueError(
                f"{addr} answered role={reply.get('role')!r}, "
                f"expected {pool!r} — check the pool wiring")
        workers.append(w)
        _telemetry.counter("cluster.workers_added",
                           {"pool": pool}).inc()

    def remove_worker(self, addr: str) -> None:
        """Detach a pool member (scale-down's final edge, after
        :meth:`drain_worker` migrated its state — or a hard removal,
        in which case any in-flight requests requeue like a death)."""
        w = self._find_worker(addr)
        if w.in_flight:
            self._requeue_worker(w)
        w.kill()
        for pool in (self._prefill, self._decode):
            if w in pool:
                pool.remove(w)
        _telemetry.counter("cluster.workers_removed",
                           {"pool": w.pool}).inc()

    def drain_worker(self, addr: str) -> dict:
        """LOSSLESS scale-down: stop admitting onto the
        worker, pull every in-flight request's state out of it, and
        migrate each one onto a survivor → ``{"migrated", "requeued",
        "completed"}`` counts.

        A decode worker answers the ``drain`` RPC with one record per
        live lane — the cache's token sequence, the pending token, the
        remaining budget, and the per-token K/V on the RAW wire
        (bit-exact by contract: a migration must not change one
        token) — plus the rids of its still-queued requests and any
        completed-but-unpolled responses.  Each live record re-enters
        a survivor through the SAME decode RPC a prefill handoff uses
        (the router never deserializes the blobs), with the
        already-generated prefix parked on the pending entry for
        :meth:`_finalize` to stitch back.  Requests that cannot
        migrate (no survivor headroom, survivor refused, or the worker
        died mid-drain) requeue at the FRONT of their class queue for
        a fresh prefill→decode dispatch — slower, never lost.

        Prefill workers hold no request state: draining one is just
        the flag (dispatch routes around it immediately)."""
        w = self._find_worker(addr)
        w.draining = True
        out = {"migrated": 0, "requeued": 0, "completed": 0}
        if w.pool == "prefill":
            return out
        completed: List[ClusterResponse] = []
        try:
            reply, blobs = w.rpc({"op": "drain"})
        except (WorkerDied, RuntimeError) as e:
            self._feed_pool("decode", False, str(e))
            n = len(w.in_flight)
            self._requeue_worker(w)
            out["requeued"] = n
            return out
        # completed-but-unpolled responses ride the drain reply so
        # they are not lost with the worker
        for rec in reply.get("responses", []):
            pend = w.in_flight.pop(rec["rid"], None)
            if pend is not None:
                completed.append(self._finalize(pend, rec, w))
        bi = 0
        to_requeue: List[_Pending] = []
        for rec in reply.get("live", []):
            nb = int(rec.get("n_blobs", 0))
            rblobs = blobs[bi: bi + nb]
            bi += nb
            pend = w.in_flight.pop(rec["rid"], None)
            if pend is None:
                continue
            if self._migrate(pend, rec, rblobs):
                out["migrated"] += 1
            else:
                to_requeue.append(pend)
        for rid in reply.get("requeue", []):
            pend = w.in_flight.pop(rid, None)
            if pend is not None:
                to_requeue.append(pend)
        # NEWEST first so the last appendleft leaves the OLDEST at the
        # queue front — the same age-preserving order _requeue_worker
        # uses (the oldest request is closest to its deadline)
        for pend in sorted(to_requeue, key=lambda p: p.rid,
                           reverse=True):
            self._requeue_pending(pend)
        out["requeued"] += len(to_requeue)
        if w.in_flight:           # belt and braces: nothing is lost
            n = len(w.in_flight)
            self._requeue_worker(w)
            out["requeued"] += n
        out["completed"] = len(completed)
        self._completed_total += len(completed)
        self._drain_completed.extend(completed)
        self._set_gauges()
        return out

    def _migrate(self, pend: _Pending, rec: dict,
                 rblobs: List[bytes]) -> bool:
        """Re-inject one drained request into a survivor; False =
        caller requeues it for a fresh dispatch instead."""
        target = self._pick_decode()
        if target is None:
            return False
        try:
            target.rpc({
                "op": "decode",
                "rid": pend.rid,
                "prompt": rec["prompt"],
                "first_token": int(rec["first_token"]),
                "prefill_ms": float(rec.get("prefill_ms", 0.0)),
                "kv": rec["kv"],
                "slo_class": pend.slo_class,
                "max_new_tokens": int(rec["max_new_tokens"]),
                "temperature": float(rec.get("temperature", 0.0)),
                "eos_token_id": rec.get("eos_token_id"),
                "adapter_id": int(rec.get("adapter_id", 0)),
            }, rblobs)
        except WorkerDied as e:
            self._feed_pool("decode", False, str(e))
            return False
        except RuntimeError:
            return False
        self._feed_pool("decode", True)
        # EXTEND, never replace: done_tokens covers only what THIS
        # worker generated — a request migrated twice carries the
        # first leg's tokens in prior_tokens already, and overwriting
        # would silently truncate the stitched response
        pend.prior_tokens = (pend.prior_tokens
                             + list(rec.get("done_tokens", []))[:-1])
        pend.migrations += 1
        pend.prior_preemptions += int(rec.get("preemptions", 0))
        pend.prior_decode_steps += int(rec.get("decode_polls", 0))
        pend.handoff_bytes += sum(len(b) for b in rblobs)
        target.in_flight[pend.rid] = pend
        target.dispatched_since_poll += 1
        _telemetry.counter("cluster.migrated").inc()
        _telemetry.counter("cluster.handoff_bytes").inc(
            sum(len(b) for b in rblobs))
        return True

    def take_drain_completions(self) -> List[ClusterResponse]:
        """Responses that completed on a worker between its last poll
        and its drain (banked by :meth:`drain_worker`) — collect them
        like a step()'s return.  The controller forwards these to its
        caller so a drain never swallows a finished request."""
        out, self._drain_completed = self._drain_completed, []
        return out

    # -- operator surface ---------------------------------------------------

    def stats(self) -> dict:
        return {
            "queued_by_class": {cls: len(q)
                                for cls, q in self._queues.items()},
            "queued": sum(len(q) for q in self._queues.values()),
            "inflight": sum(len(w.in_flight) for w in self._decode),
            "completed": self._completed_total,
            "requeued": self._requeued_total,
            "pools": {
                "prefill": [{"addr": w.addr, "alive": w.alive,
                             "draining": w.draining}
                            for w in self._prefill],
                "decode": [{"addr": w.addr, "alive": w.alive,
                            "draining": w.draining,
                            "stats": w.stats} for w in self._decode],
            },
            "wire_dtype": self.wire_dtype,
        }

    def scrape_stats(self) -> None:
        """Refresh every live worker's stats snapshot out-of-band (the
        poll path refreshes decode workers for free; this also covers
        prefill workers and a router that is idle)."""
        for w in self._prefill + self._decode:
            if not w.alive:
                continue
            try:
                reply, _ = w.rpc({"op": "stats"})
                w.stats = reply.get("stats", {})
                # a fresh snapshot REFLECTS the dispatches since the
                # last refresh (they are in its queued/active now) —
                # keeping the correction would double-count them and
                # read the worker as saturated when it is not
                w.dispatched_since_poll = 0
                self._feed_pool(w.pool, True)
            except (WorkerDied, RuntimeError) as e:
                self._feed_pool(w.pool, False, str(e))

    def autoscale_signal(self,
                         fleet_summary: Optional[dict] = None) -> dict:
        """Per-pool scaling hints from the live admission signals,
        optionally sharpened by a *windowed* fleet aggregate
        (the JAX package's ``aggregate_telemetry --json --window N``
        form — recent percentiles, not lifetime totals).  ``+1`` = grow the pool,
        ``-1`` = it can shrink, ``0`` = hold.  Emitted as
        ``cluster.scale_hint{pool=}`` gauges; the mapping is
        deliberately simple — the VALUE is that the inputs are real
        (exact merged percentiles + live headroom), not that the
        policy is clever."""
        out: dict = {}
        queued = sum(len(q) for q in self._queues.values())
        # a draining worker is LEAVING: it takes no new work, so it
        # contributes no capacity to the signal — an all-draining pool
        # is an empty pool about to happen, which must read as "grow",
        # never as idle headroom
        alive_d = [w for w in self._decode
                   if w.alive and not w.draining]
        alive_p = [w for w in self._prefill
                   if w.alive and not w.draining]
        # decode pool: headroom exhaustion or router backpressure says
        # grow; broad idle headroom says shrink.  Headroom is measured
        # in TOKENS ADMITTABLE (see _headroom_tokens: a byte-blind
        # signal would over-spawn on quantized fleets; same conversion
        # as dispatch ordering so the hint and _pick_decode agree).
        headroom = sum(_headroom_tokens(w.stats) for w in alive_d)
        # host-tier headroom: free host-DRAM across the
        # pool.  Not admission capacity (lanes live in HBM), but it
        # changes what HBM exhaustion COSTS — with parking room, a
        # preemption resumes via page-in instead of replaying its
        # prefill, so exhaustion with an empty router queue is
        # tolerable where it would otherwise demand growth.
        host_free = sum(
            w.stats.get("host_tier", {}).get("free_bytes", 0)
            for w in alive_d)
        occ = [w.stats.get("active", 0) / w.stats["max_slots"]
               for w in alive_d if w.stats.get("max_slots")]
        mean_occ = sum(occ) / len(occ) if occ else 0.0
        d_hint = 0
        if not alive_d or headroom == 0 or queued > 2 * max(
                len(alive_d), 1):
            d_hint = 1
            if (alive_d and queued == 0 and headroom == 0
                    and host_free > 0):
                # exhausted HBM but nothing queued and room to park:
                # preemptions degrade to cheap page-in resumes — hold
                d_hint = 0
        elif mean_occ < 0.2 and queued == 0 and len(alive_d) > 1:
            d_hint = -1
        p_hint = 0
        if not alive_p:
            p_hint = 1
        # the windowed fleet evidence: a class whose RECENT p95 TTFT
        # violates its deadline wants more prefill (TTFT is prefill +
        # queue); a violated TPOT wants more decode
        violations: List[str] = []
        for cls, target in self._slo_targets.items():
            row = (fleet_summary or {}).get("sketches", {}).get(
                f"serving.ttft_ms{{slo_class={cls}}}")
            if (row and target.ttft_ms is not None
                    and row.get("p95", 0) > target.ttft_ms):
                p_hint = 1
                violations.append(f"{cls}:ttft")
            row = (fleet_summary or {}).get("sketches", {}).get(
                f"serving.tpot_ms{{slo_class={cls}}}")
            if (row and target.tpot_ms is not None
                    and row.get("p95", 0) > target.tpot_ms):
                d_hint = 1
                violations.append(f"{cls}:tpot")
        out["decode"] = {"workers": len(alive_d), "hint": d_hint,
                         "headroom_tokens": headroom,
                         "host_tier_free_bytes": host_free,
                         "mean_occupancy": round(mean_occ, 4),
                         "router_queue": queued,
                         "draining": sum(1 for w in self._decode
                                         if w.alive and w.draining)}
        out["prefill"] = {"workers": len(alive_p), "hint": p_hint,
                          "draining": sum(1 for w in self._prefill
                                          if w.alive and w.draining)}
        if violations:
            out["slo_violations"] = violations
        _telemetry.gauge("cluster.scale_hint", {"pool": "decode"}).set(
            d_hint)
        _telemetry.gauge("cluster.scale_hint", {"pool": "prefill"}).set(
            p_hint)
        return out

    @staticmethod
    def load_fleet_summary(path: str) -> dict:
        """Read an ``aggregate_telemetry --json`` artifact (the
        autoscaling substrate)."""
        with open(path) as f:
            return json.load(f)

    def close(self, shutdown_workers: bool = False) -> None:
        for w in self._prefill + self._decode:
            if shutdown_workers and w.alive:
                try:
                    w.rpc({"op": "shutdown"})
                except (WorkerDied, RuntimeError):
                    pass
            w.kill()
